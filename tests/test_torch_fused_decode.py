"""Fused decode (``decode_steps=K``) in the port's ``ServingEngine``
against the JAX package's, on ``GPT2Config.tiny()`` in fp32 on the CPU —
the cases of ``tests/unit/test_fused_decode.py`` the port runs: chunked
parity with the fence accounting, eos inside a window, kv8 bit-exactness,
preemption at the fence, and ``decode_steps`` validation.  In each, the
K-step window's tokens equal the K = 1 loop's (the contract at
``deepspeed_tpu/__init__.py:251-255``) and the JAX server's, and
``decode_steps`` / ``fused_iterations`` / ``host_fence_waits`` equal the
JAX server's ``stats()`` on the same trace.  On the CPU the window runs
eagerly (no CUDA graph)."""

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import Request as JRequest
from deepspeed_tpu.inference.serving import ServingEngine as JServingEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference.serving import Request, ServingEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

FENCE_KEYS = ("decode_steps", "fused_iterations", "host_fence_waits")


@pytest.fixture(scope="module")
def engines():
    """One JAX and one port engine over the same tiny fp32 weights."""
    deepspeed_tpu.comm.reset_topology()
    cfg = jgpt2.GPT2Config.tiny(max_seq_len=128)
    jparams = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    jeng = deepspeed_tpu.init_inference(
        jgpt2.build(cfg), config={"dtype": "fp32",
                                  "tensor_parallel": {"tp_size": 1}},
        params=jparams)
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tgpt2.GPT2Config.tiny(max_seq_len=128)),
        config={"dtype": "fp32"}, params=tgpt2.params_from_jax(jparams),
        device="cpu")
    return cfg, jeng, teng


def _trace(vocab, n, prefix_len=24, seed=0, tail=(3, 10), max_new=(2, 12)):
    """``test_fused_decode.py``'s shared-prefix trace as (uid, prompt,
    max_new_tokens) triples."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    return [(i, np.concatenate([prefix, rng.integers(0, vocab,
                                                     int(rng.integers(*tail)))]),
             int(rng.integers(*max_new))) for i in range(n)]


def _serve(engines, trace, eos=None, **kw):
    """Serve ``trace`` on a port server and a JAX server built alike;
    returns (port results, port server, JAX results, JAX server)."""
    _, jeng, teng = engines
    deepspeed_tpu.comm.reset_topology()
    jsrv = JServingEngine(jeng, **kw)
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace],
                      eos_token_id=eos)
    tsrv = ServingEngine(teng, **kw)
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace],
                     eos_token_id=eos)
    return got, tsrv, want, jsrv


def _same(a, b, trace):
    for u, _, _ in trace:
        np.testing.assert_array_equal(np.asarray(a[u]), np.asarray(b[u]),
                                      err_msg=f"uid {u}")


def test_fused_parity_chunked_and_fence_accounting(engines):
    cfg, _, teng = engines
    kw = dict(slots=4, max_seq_len=128, block_size=8, prefill_chunk=16,
              prefill_batch=2)
    trace = _trace(cfg.vocab_size, 6)
    r1, s1, _, _ = _serve(engines, trace, **kw)
    rK, sK, jK, jsK = _serve(engines, trace, decode_steps=4, **kw)
    _same(r1, rK, trace)
    _same(rK, jK, trace)
    for u, p, m in trace:
        np.testing.assert_array_equal(
            rK[u], teng.generate(p[None, :], max_new_tokens=m)[0])
    st1, stK, jst = s1.stats(), sK.stats(), jsK.stats()
    for key in FENCE_KEYS:
        assert stK[key] == jst[key], key
    assert stK["fused_iterations"] == stK["decode_steps"] > 0
    assert st1["fused_iterations"] == 0 == st1["host_fence_waits"]
    assert 0 < stK["host_fence_waits"] <= stK["decode_steps"]
    assert stK["host_fence_waits"] <= -(-st1["decode_steps"] // 4) + \
        len(trace)
    assert stK["generated_tokens"] == st1["generated_tokens"]
    # on the CPU the step runs eagerly: nothing is captured
    assert stK["captured_graphs"] == 0 == st1["captured_graphs"]


def test_fused_parity_eos_inside_window(engines):
    cfg, _, teng = engines
    kw = dict(slots=3, max_seq_len=128, block_size=8, prefill_chunk=16,
              prefill_batch=2)
    trace = _trace(cfg.vocab_size, 4, seed=1, max_new=(6, 12))
    p0 = trace[0][1]
    eos = int(teng.generate(p0[None, :], max_new_tokens=1)[0, len(p0)])
    rK, sK, jK, jsK = _serve(engines, trace, eos=eos, decode_steps=8, **kw)
    _same(rK, jK, trace)
    for u, p, m in trace:
        np.testing.assert_array_equal(
            rK[u], teng.generate(p[None, :], max_new_tokens=m,
                                 eos_token_id=eos)[0])
    gen0 = np.asarray(rK[0])[len(p0):]
    assert gen0[0] == eos and np.all(gen0 == eos)
    for key in FENCE_KEYS:
        assert sK.stats()[key] == jsK.stats()[key], key


def test_fused_parity_kv8_bit_exact(engines):
    cfg = engines[0]
    kw = dict(slots=4, max_seq_len=128, block_size=8, prefill_chunk=16,
              prefill_batch=2, quantize="kv8")
    trace = _trace(cfg.vocab_size, 6, seed=2)
    r1, _, _, _ = _serve(engines, trace, **kw)
    rK, sK, jK, jsK = _serve(engines, trace, decode_steps=4, **kw)
    _same(r1, rK, trace)
    _same(rK, jK, trace)
    assert sK.stats()["kv_dtype"] == "int8"
    for key in FENCE_KEYS:
        assert sK.stats()[key] == jsK.stats()[key], key


def test_fused_preemption_at_fence_keeps_parity(engines):
    cfg, _, teng = engines
    rng = np.random.default_rng(5)
    trace = [(i, rng.integers(0, cfg.vocab_size, 17), 28) for i in range(5)]
    rK, sK, jK, jsK = _serve(
        engines, trace, slots=3, max_seq_len=64, block_size=8,
        prefill_chunk=32, prefill_batch=2, num_blocks=12, decode_steps=4)
    assert sK.preempted > 0 and sK.preempted == jsK.preempted
    _same(rK, jK, trace)
    for u, p, m in trace:
        np.testing.assert_array_equal(
            rK[u], teng.generate(p[None, :], max_new_tokens=m)[0])
    for key in FENCE_KEYS:
        assert sK.stats()[key] == jsK.stats()[key], key


@pytest.mark.parametrize("steps", [0, -3])
def test_decode_steps_validation(engines, steps):
    _, _, teng = engines
    kw = dict(slots=4, max_seq_len=128, block_size=8, prefill_chunk=16)
    with pytest.raises(ValueError, match="decode_steps"):
        ServingEngine(teng, decode_steps=steps, **kw)
    with pytest.raises(ValueError, match="decode_steps"):
        deepspeed_tpu_torch.init_serving(teng.module, params=teng.params,
                                         config={"dtype": "fp32"},
                                         device="cpu", decode_steps=steps,
                                         **kw)
