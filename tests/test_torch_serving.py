"""The PyTorch port's paged ``ServingEngine`` against the JAX package's, and
against the port's own ``generate``, on ``GPT2Config.tiny()`` in fp32:
token-exact on the shared-prefix and preemption traces of
``tests/unit/test_paged_serving.py``.  Also: the entry points' device rule,
the options this slice refuses, and the package's isolation from JAX."""

import subprocess
import sys
from pathlib import Path

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


def _shared_prefix_trace(vocab, n, prefix_len=24, seed=0, tail=(3, 10),
                         max_new=(2, 10)):
    """(uid, prompt, max_new_tokens) triples — ``test_paged_serving.py``'s
    shared-prefix trace."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    return [(i, np.concatenate([prefix, rng.integers(0, vocab,
                                                     int(rng.integers(*tail)))]),
             int(rng.integers(*max_new))) for i in range(n)]


def _serve_both(engines, trace, eos=None, **kw):
    cfg, jeng, teng = engines
    deepspeed_tpu.comm.reset_topology()
    jsrv = JServingEngine(jeng, sampling=False, **kw)
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace],
                      eos_token_id=eos)
    tsrv = ServingEngine(teng, **kw)
    log = []
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace],
                     eos_token_id=eos, admission_log=log)
    assert set(got) == set(want)
    for u, p, m in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
        gen = teng.generate(p[None, :], max_new_tokens=m, eos_token_id=eos)
        np.testing.assert_array_equal(got[u], gen[0], err_msg=f"uid {u}")
    return jsrv, tsrv, log


def test_shared_prefix_trace_token_exact(engines):
    cfg = engines[0]
    jsrv, tsrv, _ = _serve_both(
        engines, _shared_prefix_trace(cfg.vocab_size, 6), slots=4,
        max_seq_len=128, block_size=8, prefill_chunk=16, prefill_batch=2)
    st, jst = tsrv.stats(), jsrv.stats()
    for key in ("admitted", "evicted", "prefill_calls", "decode_steps",
                "prefix_hit_tokens", "prompt_tokens", "blocks_in_use",
                "free_blocks", "num_blocks"):
        assert st[key] == jst[key], key
    assert st["prefix_cache_hit_rate"] > 0.2
    assert st["prefix_hit_tokens"] % tsrv.block_size == 0
    for key in ("decode_attention_cuda_launches",
                "paged_decode_attention_cuda_launches",
                "paged_verify_attention_cuda_launches", "ttft_p50_s",
                "ttft_p95_s", "prefix_cache_hit_rate"):
        assert key in st, key


def test_shared_prefix_trace_with_eos_and_wide_chunks(engines):
    """eos back-fill, and prefill windows wider than the verify kernel's
    (the gather path)."""
    cfg, _, teng = engines
    trace = _shared_prefix_trace(cfg.vocab_size, 4, seed=1, max_new=(4, 10))
    eos = int(teng.generate(trace[0][1][None, :], max_new_tokens=1)[0, -1])
    _serve_both(engines, trace, eos=eos, slots=3, max_seq_len=128,
                block_size=8, prefill_chunk=32, prefill_batch=2)


def test_preemption_under_block_pressure_token_exact(engines):
    """``test_paged_serving.py``'s oversubscribed pool: decode growth forces
    preemption + FIFO re-queue + recompute; outputs stay exact."""
    cfg = engines[0]
    rng = np.random.default_rng(5)
    trace = [(i, rng.integers(0, cfg.vocab_size, 17), 28) for i in range(5)]
    jsrv, tsrv, log = _serve_both(
        engines, trace, slots=3, max_seq_len=64, block_size=8,
        prefill_chunk=32, prefill_batch=2, num_blocks=12)
    assert tsrv.preempted > 0 and tsrv.preempted == jsrv.preempted
    first = []
    for uid, _ in log:
        if uid not in first:
            first.append(uid)
    assert first == list(range(5))


def test_prefix_cache_reuse_across_serve_calls(engines):
    _, _, teng = engines
    srv = ServingEngine(teng, slots=2, max_seq_len=128, block_size=8,
                        prefill_chunk=32, prefill_batch=2)
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 512, 32)                 # 4 full blocks

    def mk(uid, seed):
        tail = np.random.default_rng(seed).integers(0, 512, 5)
        return Request(uid=uid, prompt=np.concatenate([prefix, tail]),
                       max_new_tokens=4)

    srv.serve([mk(0, 0)])
    hit0 = srv.prefix_hit_tokens
    res = srv.serve([mk(1, 1), mk(2, 2)])
    assert srv.prefix_hit_tokens - hit0 == 2 * 32
    for uid, seed in ((1, 1), (2, 2)):
        want = teng.generate(mk(uid, seed).prompt[None, :], max_new_tokens=4)
        np.testing.assert_array_equal(res[uid], want[0])


def test_submit_step_and_streaming_handles(engines):
    _, _, teng = engines
    srv = ServingEngine(teng, slots=2, max_seq_len=64, block_size=8,
                        prefill_chunk=16)
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, 9), max_new_tokens=5)
            for i in range(3)]
    handles = [srv.submit(r, priority=p) for r, p in zip(reqs, (0, 0, 1))]
    with pytest.raises(ValueError, match="in flight"):
        srv.submit(reqs[0])
    streamed = []
    while srv.step():
        tok = handles[2].next_token(timeout=0)
        if tok is not None:
            streamed.append(tok)
    while (tok := handles[2].next_token(timeout=0)) is not None:
        streamed.append(tok)
    for r, h in zip(reqs, handles):
        assert h.done
        want = teng.generate(r.prompt[None, :], max_new_tokens=5)[0]
        np.testing.assert_array_equal(h.result(timeout=0), want)
    assert streamed == handles[2].tokens() and len(streamed) == 5
    with pytest.raises(ValueError, match="max_seq_len"):
        srv.submit(Request(uid=9, prompt=np.zeros(60, np.int32),
                           max_new_tokens=10))


def test_init_serving_refuses_unported_options(engines):
    model = tgpt2.build(tgpt2.GPT2Config.tiny())
    for kw, word in (({"sampling": True}, "sampling"),
                     ({"decode_steps": 4}, "fused"),
                     ({"spec_tokens": 3}, "speculative"),
                     ({"quantize": "kv8"}, "kv8"),
                     ({"host_blocks": 8}, "tier"),
                     ({"resident_window_blocks": 4}, "tier"),
                     ({"sp": 2}, "multi-GPU"),
                     ({"engine_mode": "dp_tp"}, "multi-GPU"),
                     ({"topology": 2}, "multi-GPU")):
        kw = {"sampling": False, **kw}
        with pytest.raises(NotImplementedError, match=word):
            deepspeed_tpu_torch.init_serving(model, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        deepspeed_tpu_torch.init_serving(
            model, config={"tensor_parallel": {"tp_size": 2}}, device="cpu",
            sampling=False)
    srv = deepspeed_tpu_torch.init_serving(model, device="cpu",
                                           sampling=False, max_seq_len=64,
                                           block_size=8)
    assert srv.device.type == "cpu" and srv.prefill_chunk == 64


def test_entry_points_default_to_cuda():
    """With no device given the entry points take CUDA, and raise when no
    GPU is present — they never fall back to the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    model = tgpt2.build(tgpt2.GPT2Config.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_serving(model, sampling=False)


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import deepspeed_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'deepspeed_tpu.')) or n == 'deepspeed_tpu')\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15          # every module imported
