"""Per-slot sampling through the port's ``ServingEngine`` on
``GPT2Config.tiny()`` in fp32 on the CPU — the cases of
``tests/unit/test_sampled_serving.py`` that need no constrained decoding
or speculative verify: deterministic streams, temperature-0 rows identical
to greedy, fused composition, preemption replay, and request and engine
validation.  Against the JAX server, a sampled trace's streams are held
by per-request token agreement >= 0.95 (the bf16 contract of
``tests/unit/quant_divergence.py``): across frameworks the logits differ
in the last ulps, which moves a draw where two perturbed scores nearly
tie, so streams are compared this way and not bit for bit."""

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

_KW = dict(slots=4, max_seq_len=128, block_size=8, prefill_chunk=16,
           prefill_batch=2)


@pytest.fixture(scope="module")
def engines():
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


def _sampled_trace(vocab, n, seed=0, temperature=0.8, top_k=20, top_p=0.95,
                   plen=(5, 30), max_new=(6, 20), greedy_every=0):
    """``test_sampled_serving.py``'s trace as keyword dicts: n requests,
    all sampled unless ``greedy_every`` interleaves greedy rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        greedy = greedy_every and i % greedy_every == 0
        out.append(dict(
            uid=i, prompt=rng.integers(0, vocab, int(rng.integers(*plen))),
            max_new_tokens=int(rng.integers(*max_new)),
            temperature=0.0 if greedy else temperature,
            top_k=0 if greedy else top_k,
            top_p=1.0 if greedy else top_p,
            seed=0 if greedy else int(rng.integers(1, 2 ** 31 - 1))))
    return out


def _reqs(trace, cls=Request):
    return [cls(**r) for r in trace]


def _same(a, b, trace):
    for r in trace:
        np.testing.assert_array_equal(np.asarray(a[r["uid"]]),
                                      np.asarray(b[r["uid"]]),
                                      err_msg=f"uid {r['uid']}")


def test_sampled_streams_deterministic(engines):
    cfg, _, teng = engines
    trace = _sampled_trace(cfg.vocab_size, 6)
    a, b = ServingEngine(teng, **_KW), ServingEngine(teng, **_KW)
    res_a, res_b = a.serve(_reqs(trace)), b.serve(_reqs(trace))
    _same(res_a, res_b, trace)
    greedy = {r["uid"]: teng.generate(r["prompt"][None, :],
                                      max_new_tokens=r["max_new_tokens"])[0]
              for r in trace}
    assert any(not np.array_equal(res_a[u], g) for u, g in greedy.items()), \
        "sampling never deviated from greedy"
    st = a.stats()
    assert st["sampling"] is True and st["sampled_requests"] == len(trace)


def test_temp0_rows_bit_identical_to_greedy_engine(engines):
    cfg, _, teng = engines
    trace = _sampled_trace(cfg.vocab_size, 5, seed=1, greedy_every=1)
    assert not any(Request(**r).sampled for r in trace)
    on = ServingEngine(teng, **_KW)
    off = ServingEngine(teng, sampling=False, **_KW)
    res_on, res_off = on.serve(_reqs(trace)), off.serve(_reqs(trace))
    for r in trace:
        want = teng.generate(r["prompt"][None, :],
                             max_new_tokens=r["max_new_tokens"])[0]
        np.testing.assert_array_equal(res_on[r["uid"]], want)
        np.testing.assert_array_equal(res_off[r["uid"]], want)
    assert on.stats()["sampled_requests"] == 0


def test_fused_decode_composes_token_identical(engines):
    cfg, _, teng = engines
    trace = _sampled_trace(cfg.vocab_size, 5, seed=2, greedy_every=3)
    plain = ServingEngine(teng, **_KW)
    fused = ServingEngine(teng, decode_steps=4, **_KW)
    _same(plain.serve(_reqs(trace)), fused.serve(_reqs(trace)), trace)
    assert fused.stats()["fused_iterations"] > 0


def test_preemption_replays_sampled_streams_token_exact(engines):
    """A tight pool forces preempt -> resume mid-stream; the resumed
    continuation re-derives its keys from (seed, emitted count) and
    matches an unpressured run token for token, at K = 1 and K = 4."""
    cfg, _, teng = engines
    rng = np.random.default_rng(9)
    trace = [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size, 17),
                  max_new_tokens=28, temperature=0.8, top_k=30, top_p=0.9,
                  seed=int(rng.integers(1, 2 ** 31 - 1))) for i in range(5)]
    want = ServingEngine(teng, **_KW).serve(_reqs(trace))
    for k in (1, 4):
        tight = ServingEngine(teng, slots=3, max_seq_len=64, block_size=8,
                              prefill_chunk=32, prefill_batch=2,
                              num_blocks=12, decode_steps=k)
        got = tight.serve(_reqs(trace))
        assert tight.preempted > 0, tight.stats()
        _same(got, want, trace)


def test_request_and_engine_validation(engines):
    _, _, teng = engines
    prompt = np.arange(5)
    for kw, word in (({"temperature": -0.5}, "temperature"),
                     ({"top_k": -1}, "top_k"), ({"top_p": 0.0}, "top_p"),
                     ({"top_p": 1.5}, "top_p"), ({"seed": -1}, "seed"),
                     ({"seed": 2 ** 32}, "seed")):
        with pytest.raises(ValueError, match=word):
            Request(uid=0, prompt=prompt, max_new_tokens=4, **kw)
    Request(uid=0, prompt=prompt, max_new_tokens=4, seed=2 ** 32 - 1)
    # a mask builder needs an engine with the constrained lane
    with pytest.raises(ValueError, match="logit_masks=True"):
        ServingEngine(teng, **_KW).submit(Request(
            uid=0, prompt=prompt, max_new_tokens=4, mask_builder=object()))
    off = ServingEngine(teng, sampling=False, **_KW)
    with pytest.raises(ValueError, match="sampling=False"):
        off.submit(Request(uid=1, prompt=prompt, max_new_tokens=4,
                           temperature=0.7, seed=3))
    with pytest.raises(ValueError, match="sampling=False"):
        off.serve([Request(uid=2, prompt=prompt, max_new_tokens=4,
                           temperature=0.7)])
    with pytest.raises(ValueError, match="logit_masks=True needs the "
                       "sampling stack"):
        deepspeed_tpu_torch.init_serving(teng.module, device="cpu",
                                         logit_masks=True, sampling=False,
                                         **_KW)


def test_sampled_streams_agree_with_the_jax_server(engines):
    """A sampled trace (temperature 0.8, top_k 20, top_p 0.95, per-request
    seeds) through both servers at fp32: each request's tokens agree on
    >= 0.95 of its positions; most requests match exactly."""
    cfg, jeng, teng = engines
    trace = _sampled_trace(cfg.vocab_size, 8, seed=4, greedy_every=4)
    deepspeed_tpu.comm.reset_topology()
    want = JServingEngine(jeng, **_KW).serve(_reqs(trace, JRequest))
    got = ServingEngine(teng, **_KW).serve(_reqs(trace))
    agree = {r["uid"]: float(np.mean(np.asarray(got[r["uid"]])
                                     == np.asarray(want[r["uid"]])))
             for r in trace}
    exact = sum(a == 1.0 for a in agree.values())
    print(f"sampled trace vs the JAX server: {exact} of {len(trace)} "
          f"requests exact, agreement {agree}")
    assert min(agree.values()) >= 0.95, agree
    assert exact >= len(trace) // 2, agree
