"""Constrained decoding (``logit_masks=True``) in the port against the JAX
package, on ``GPT2Config.tiny()`` in fp32 on the CPU: the port's copy of
``inference/constrain.py`` (``JsonMaskBuilder``, ``ascii_token_strings``)
gives the JAX builder's masks over seeded token streams; a constrained
trace (JSON builders over the char-level table, sampled and greedy rows)
is token-exact against the JAX server with and without ``spec_tokens=3``,
and every completion parses as JSON; a ``mask_builder`` on an engine
without the lane is refused as the JAX server refuses it."""

import json

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import constrain as jcon
from deepspeed_tpu.inference.serving import Request as JRequest
from deepspeed_tpu.inference.serving import ServingEngine as JServingEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference import constrain as tcon
from deepspeed_tpu_torch.inference.serving import Request, ServingEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

_KW = dict(slots=4, max_seq_len=128, block_size=8, prefill_chunk=16,
           prefill_batch=2)
_EOS = 0


@pytest.mark.parametrize("vocab", [0, 33, 128, 512])
def test_ascii_token_strings_equal_jax(vocab):
    assert tcon.ascii_token_strings(vocab) == jcon.ascii_token_strings(vocab)


def _walk(builder_cls, toks, rng, steps, budget):
    """Masks of ``builder_cls`` along a stream that takes a random allowed
    token at each step (the same choices for both packages: the rng draw
    is over the mask's allowed ids)."""
    b = builder_cls(toks, eos_token_id=_EOS)
    stream, masks = [], []
    for i in range(steps):
        m = b.allowed(stream, budget - i)
        masks.append(m)
        ids = np.flatnonzero(m)
        tok = int(ids[rng.integers(ids.size)])
        stream.append(tok)
        if tok == _EOS:
            break
    return masks


@pytest.mark.parametrize("seed", range(4))
def test_json_mask_builder_equals_jax(seed):
    toks = jcon.ascii_token_strings(128)
    budget = 6 + 4 * seed
    want = _walk(jcon.JsonMaskBuilder, toks, np.random.default_rng(seed),
                 budget, budget)
    got = _walk(tcon.JsonMaskBuilder, toks, np.random.default_rng(seed),
                budget, budget)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a stream that breaks the JSON prefix is loud in both
    tid = {s: i for i, s in enumerate(toks) if s}
    for mod in (jcon, tcon):
        with pytest.raises(ValueError):
            mod.JsonMaskBuilder(toks, eos_token_id=_EOS).allowed(
                [tid["0"], tid["1"]], 8)
        with pytest.raises(ValueError):
            mod.JsonMaskBuilder(toks, eos_token_id=len(toks))


@pytest.fixture(scope="module")
def engines():
    deepspeed_tpu.comm.reset_topology()
    cfg = jgpt2.GPT2Config.tiny(max_seq_len=128)
    jp = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    jeng = deepspeed_tpu.init_inference(
        jgpt2.build(cfg), config={"dtype": "fp32",
                                  "tensor_parallel": {"tp_size": 1}},
        params=jp)
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tgpt2.GPT2Config.tiny(max_seq_len=128)),
        config={"dtype": "fp32"}, params=tgpt2.params_from_jax(jp),
        device="cpu")
    return cfg, jeng, teng


def _trace(cfg, seed=5):
    """Four constrained requests (three sampled, one greedy) and two free
    ones (one sampled), as keyword dicts; each constrained request gets a
    fresh builder per server (builders are stateful)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        greedy = i in (2, 5)
        out.append(dict(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, 12),
            max_new_tokens=int(rng.integers(10, 24)),
            temperature=0.0 if greedy else 0.7, top_k=0 if greedy else 40,
            top_p=1.0, seed=0 if greedy else int(rng.integers(1, 2 ** 31 - 1)),
            constrained=i < 4))
    return out


def _reqs(trace, cls, mod, toks):
    return [cls(**{k: v for k, v in r.items() if k != "constrained"},
                mask_builder=mod.JsonMaskBuilder(toks, eos_token_id=_EOS)
                if r["constrained"] else None) for r in trace]


@pytest.mark.parametrize("spec_tokens", [0, 3])
def test_constrained_trace_token_exact_with_jax(engines, spec_tokens):
    cfg, jeng, teng = engines
    toks = tcon.ascii_token_strings(cfg.vocab_size)
    trace = _trace(cfg)
    deepspeed_tpu.comm.reset_topology()
    jsrv = JServingEngine(jeng, logit_masks=True, spec_tokens=spec_tokens,
                          **_KW)
    tsrv = ServingEngine(teng, logit_masks=True, spec_tokens=spec_tokens,
                         **_KW)
    want = jsrv.serve(_reqs(trace, JRequest, jcon, toks), eos_token_id=_EOS)
    got = tsrv.serve(_reqs(trace, Request, tcon, toks), eos_token_id=_EOS)
    for r in trace:
        np.testing.assert_array_equal(got[r["uid"]], want[r["uid"]],
                                      err_msg=f"uid {r['uid']}")
        if r["constrained"]:
            gen = [int(t) for t in got[r["uid"]][len(r["prompt"]):]]
            gen = gen[:gen.index(_EOS)] if _EOS in gen else gen
            json.loads("".join(toks[t] for t in gen))
    st, js = tsrv.stats(), jsrv.stats()
    assert st["logit_masks"] is True
    assert st["sampled_requests"] == js["sampled_requests"] == 5
    for key in ("spec_rounds", "drafted_tokens", "accepted_tokens"):
        assert st[key] == js[key], key
    if spec_tokens:
        assert st["spec_rounds"] > 0


def test_constrained_fused_decode_equals_one_step(engines):
    """``decode_steps=4``: constrained slots advance one token a dispatch,
    so the tokens equal K = 1's."""
    cfg, _, teng = engines
    toks = tcon.ascii_token_strings(cfg.vocab_size)
    trace = _trace(cfg, seed=6)
    one = ServingEngine(teng, logit_masks=True, **_KW).serve(
        _reqs(trace, Request, tcon, toks), eos_token_id=_EOS)
    fused = ServingEngine(teng, logit_masks=True, decode_steps=4, **_KW)
    four = fused.serve(_reqs(trace, Request, tcon, toks), eos_token_id=_EOS)
    for r in trace:
        np.testing.assert_array_equal(four[r["uid"]], one[r["uid"]])
    assert fused.stats()["fused_iterations"] > 0


def test_mask_builder_needs_the_lane(engines):
    """Both servers refuse a ``mask_builder`` without ``logit_masks`` at
    ``submit`` with a ValueError; a builder returning the wrong width is
    named."""
    cfg, jeng, teng = engines
    toks = tcon.ascii_token_strings(cfg.vocab_size)
    deepspeed_tpu.comm.reset_topology()
    for srv, cls, mod in ((JServingEngine(jeng, **_KW), JRequest, jcon),
                          (ServingEngine(teng, **_KW), Request, tcon)):
        req = cls(uid=0, prompt=np.arange(5), max_new_tokens=4,
                  mask_builder=mod.JsonMaskBuilder(toks, eos_token_id=_EOS))
        with pytest.raises(ValueError, match="logit_masks=True"):
            srv.submit(req)
    short = tcon.JsonMaskBuilder(toks[:100], eos_token_id=_EOS)
    srv = ServingEngine(teng, logit_masks=True, **_KW)
    with pytest.raises(ValueError, match="vocab_size"):
        srv.serve([Request(uid=1, prompt=np.arange(5), max_new_tokens=4,
                           temperature=0.5, mask_builder=short)])
