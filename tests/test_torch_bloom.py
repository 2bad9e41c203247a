"""The PyTorch port's BLOOM family (``deepspeed_tpu_torch/models/bloom.py``)
against the JAX package's (``deepspeed_tpu/models/bloom.py``), on the CPU
at fp32.

 - ``alibi_slopes`` bit for bit at 4, 6, 12 and 32 heads;
 - ``forward`` logits and the loss within 1e-4 at 4 and 6 heads;
 - ``forward_cached`` within 1e-4: contiguous ragged prefill, per-row
   decode, paged chunks with per-row bases and pads, the verify window;
 - greedy ``generate`` and ``serve`` token-exact against the JAX engine
   and server, with prefix caching, preemption and a speculative round;
 - the w8a8 records bit for bit and ``w8a8+kv8`` serve token-exact; the
   kv8 pool's logit RMSE against the float pool at most 0.15.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import Request as JRequest
from deepspeed_tpu.models import bloom as jbloom
from deepspeed_tpu_torch.inference.serving import Request
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.ops import paged_kv
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
KV8_MAX_LOGIT_RMSE = 0.15
VARIANTS = {
    "h4": {},
    # a head count that is not a power of two: the interpolated slopes
    "h6": dict(num_heads=6, hidden_size=96),
    # whole k-groups of 128 and 128-column N: w8a8 quantizes every matrix
    "wide": dict(num_heads=2, hidden_size=128),
}


def _configs(name):
    kw = VARIANTS[name]
    return (dataclasses.replace(jbloom.BloomConfig.tiny(), **kw),
            dataclasses.replace(tbloom.BloomConfig.tiny(), **kw))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(JAX config, port config, JAX params as numpy, port params): the JAX
    initializer's shapes drawn with numpy from a seed (biases and LN
    parameters nonzero, so each one is held)."""
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jbloom.init_params(jcfg, key),
                            jax.random.PRNGKey(0))

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                ((1.0 if "scale" in k else 0.0) +
                 (0.1 if ("scale" in k or "_b" in k) else 0.05) *
                 rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    jp = draw(shapes)
    return jcfg, tcfg, jp, tbloom.params_from_jax(jp)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("heads", [4, 6, 12, 32])
def test_alibi_slopes_bit_for_bit(heads):
    got, want = tbloom.alibi_slopes(heads), jbloom.alibi_slopes(heads)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["h4", "h6"])
def test_forward_and_loss_match_jax(name):
    jcfg, tcfg, jp, tp = _weights(name)
    assert set(tp) == set(jp)
    ids = np.random.default_rng(1).integers(0, 512, (2, 12))
    want = np.asarray(jbloom.forward(jcfg, jp, jnp.asarray(ids)))
    np.testing.assert_allclose(tbloom.forward(tcfg, tp, _t(ids)).numpy(),
                               want, **TOL)
    labels = ids[:, 1:].copy()
    labels[1, :4] = -100
    jloss = jbloom.loss_from_batch(jcfg, jp, (jnp.asarray(ids[:, :-1]),
                                              jnp.asarray(labels)))
    tloss = tbloom.loss_from_batch(tcfg, tp, (_t(ids[:, :-1]), _t(labels)))
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("name", ["h4", "h6"])
def test_forward_cached_matches_jax(name):
    jcfg, tcfg, jp, tp = _weights(name)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (3, 8))
    lengths = np.array([8, 6, 2], np.int32)
    jc = jbloom.init_cache(jcfg, 3, 64, jnp.float32)
    tc = tbloom.init_cache(tcfg, 3, 64, torch.float32)
    jl, jc = jbloom.forward_cached(jcfg, jp, jnp.asarray(ids), jc, 0,
                                   lengths=jnp.asarray(lengths))
    tl, tc = tbloom.forward_cached(tcfg, tp, _t(ids), tc, 0,
                                   lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(2):
        nxt = np.asarray(jl).argmax(-1)[:, None]
        jl, jc = jbloom.forward_cached(jcfg, jp, jnp.asarray(nxt), jc, 0,
                                       lengths=jnp.asarray(lengths))
        tl, tc = tbloom.forward_cached(tcfg, tp, _t(nxt), tc, 0,
                                       lengths=_t(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        lengths = lengths + 1
    # one shared int position
    jl, _ = jbloom.forward_cached(jcfg, jp, jnp.asarray(ids[:, :4]), jc, 9)
    tl, _ = tbloom.forward_cached(tcfg, tp, _t(ids[:, :4]),
                                  {k: v.clone() for k, v in tc.items()}, 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    b, bs, nbper = 3, 4, 6
    nb = 1 + b * nbper
    bt = rng.permutation(np.arange(1, nb)).reshape(b, nbper).astype(np.int32)
    jpool = jbloom.init_cache(jcfg, nb, bs, jnp.float32)
    tpool = tbloom.init_cache(tcfg, nb, bs, torch.float32)

    def both(ids, pos, lens, all_positions=False):
        nonlocal jpool, tpool
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
        jl, jpool = jbloom.forward_cached(
            jcfg, jp, jnp.asarray(ids), jpool, jpos,
            lengths=jnp.asarray(lens), block_tables=jnp.asarray(bt),
            all_positions=all_positions)
        tl, tpool = tbloom.forward_cached(
            tcfg, tp, _t(ids), tpool, tpos, lengths=_t(lens),
            block_tables=_t(bt), all_positions=all_positions)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        return np.asarray(jl)

    ids = rng.integers(0, 512, (3, 8))
    both(ids[:, :4], np.zeros(3, np.int32), np.array([4, 4, 4], np.int32))
    # per-row bases: the bias moves with each row's absolute positions
    logits = both(ids[:, 4:], np.array([4, 3, 1], np.int32),
                  np.array([4, 3, 1], np.int32))
    lens = np.array([8, 6, 2], np.int32)
    both(logits.argmax(-1)[:, None], 0, lens)
    both(rng.integers(0, 512, (3, 3)), lens + 1, np.full(3, 3, np.int32),
         all_positions=True)
    for key in ("k", "v"):
        np.testing.assert_allclose(tpool[key][1:].numpy(),
                                   np.asarray(jpool[key])[1:], **TOL)


def _trace(vocab, n=4, seed=4, max_new=8):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16)
    return [(i, np.concatenate([prefix, rng.integers(0, vocab,
                                                     int(rng.integers(3, 12)))]),
             int(rng.integers(3, max_new))) for i in range(n)]


def _servers(name, quantize=None, **kw):
    jcfg, tcfg, jp, tp = _weights(name)
    kw = {"slots": 3, "max_seq_len": 64, "block_size": 8,
          "prefill_chunk": 16, "prefill_batch": 2, **kw}
    deepspeed_tpu.comm.reset_topology()
    jsrv = deepspeed_tpu.init_serving(
        jbloom.build(jcfg), params=jp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, **kw)
    tsrv = deepspeed_tpu_torch.init_serving(
        tbloom.build(tcfg), params=tp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, device="cpu", **kw)
    return jsrv, tsrv


def _serve_both(jsrv, tsrv, trace):
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace])
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace])
    for u, _, _ in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
    st, jst = tsrv.stats(), jsrv.stats()
    for key in ("quantize", "kv_dtype", "weight_quant", "kv_pool_bytes",
                "prefix_hit_tokens", "decode_steps", "prefill_calls"):
        assert st[key] == jst[key], key
    assert tsrv.preempted == jsrv.preempted
    return got, tsrv


# (label, server keywords, the trace's seed and length): prefix caching
# (half the requests share a 16-token prefix), preemption in a pool too
# small for the slots' growth, a speculative round of n-gram drafts
SERVE_CASES = [
    ("prefix_caching", {}, 4, 4),
    ("preemption", {"num_blocks": 12}, 5, 5),
    ("spec_tokens", {"spec_tokens": 2}, 6, 4),
    # whole-prompt prefill windows from position 0, no prefix reuse
    ("bucketed", {"prompt_buckets": [16, 32, 64]}, 7, 4),
    ("decode_steps", {"decode_steps": 3}, 8, 4),
]


@pytest.mark.parametrize("label,kw,seed,n", SERVE_CASES,
                         ids=[c[0] for c in SERVE_CASES])
def test_generate_and_serve_token_exact_with_jax(label, kw, seed, n):
    jsrv, tsrv = _servers("h6", **kw)
    trace = _trace(512, n=n, seed=seed,
                   max_new=24 if label == "preemption" else 8)
    got, srv = _serve_both(jsrv, tsrv, trace)
    if label == "prefix_caching":
        assert srv.stats()["prefix_hit_tokens"] > 0
        prompts = np.random.default_rng(5).integers(0, 512, (2, 21))
        want = np.asarray(jsrv.engine.generate(prompts, max_new_tokens=6))
        np.testing.assert_array_equal(
            tsrv.engine.generate(prompts, max_new_tokens=6), want)
    if label == "preemption":
        assert srv.preempted > 0
    if label == "spec_tokens":
        assert srv._c_spec_rounds.get() > 0
    for u, p, m in trace:
        np.testing.assert_array_equal(
            got[u], tsrv.engine.generate(p[None], max_new_tokens=m)[0])


def test_w8a8_records_and_kv8_serve_token_exact_with_jax():
    jsrv, tsrv = _servers("wide", "w8a8+kv8")
    tb = tsrv.engine.params["blocks"]
    jb = jax.device_get(jsrv.engine.params["blocks"])
    quantized = []
    for name, leaf in tb.items():
        if tq.is_k_quantized(leaf):
            quantized.append(name)
            for k in ("qk", "kscale"):
                np.testing.assert_array_equal(leaf[k].numpy(),
                                              np.asarray(jb[name][k]))
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jb[name]))
    assert sorted(quantized) == ["fc_w", "o_w", "proj_w", "qkv_w"]
    _serve_both(jsrv, tsrv, _trace(512, n=3))


def test_kv8_pool_logit_rmse():
    """The same paged prefill and decode steps over a float pool and an
    int8 pool (records written and read through ``ops/paged_kv``)."""
    _, tcfg, _, tp = _weights("h4")
    rng = np.random.default_rng(9)
    b, bs, nbper = 2, 8, 4
    bt = _t(rng.permutation(np.arange(1, 1 + b * nbper)).reshape(
        b, nbper).astype(np.int32))
    fpool = tbloom.init_cache(tcfg, 1 + b * nbper, bs, torch.float32)
    qpool = paged_kv.quantize_pool(fpool)
    ids = _t(rng.integers(0, 512, (b, 16)))
    lens = _t(np.array([16, 11], np.int32))
    zero = _t(np.zeros(b, np.int32))
    fl, _ = tbloom.forward_cached(tcfg, tp, ids, fpool, zero, lengths=lens,
                                  block_tables=bt)
    ql, _ = tbloom.forward_cached(tcfg, tp, ids, qpool, zero, lengths=lens,
                                  block_tables=bt)
    errs = [(fl - ql).pow(2).mean().sqrt().item()]
    for _ in range(4):
        nxt = fl.argmax(-1)[:, None]
        fl, _ = tbloom.forward_cached(tcfg, tp, nxt, fpool, 0, lengths=lens,
                                      block_tables=bt)
        ql, _ = tbloom.forward_cached(tcfg, tp, nxt, qpool, 0, lengths=lens,
                                      block_tables=bt)
        errs.append((fl - ql).pow(2).mean().sqrt().item())
        lens = lens + 1
    assert 0 < max(errs) <= KV8_MAX_LOGIT_RMSE, errs


def test_named_configs_and_draws():
    for fn in ("bloom_560m", "bloom_7b1"):
        j, t = getattr(jbloom.BloomConfig, fn)(), getattr(
            tbloom.BloomConfig, fn)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t), fn
        assert j.num_params() == t.num_params(), fn
    cfg = tbloom.BloomConfig.bloom_7b1()
    assert (cfg.head_dim, cfg.num_heads, cfg.num_layers) == (128, 32, 30)
    _, tcfg, jp, _ = _weights("h6")
    mine = tbloom.init_params(tcfg, torch.Generator().manual_seed(1),
                              dtype=torch.bfloat16)
    assert set(mine) == set(jp)
    for k, leaf in mine["blocks"].items():
        assert tuple(leaf.shape) == jp["blocks"][k].shape, k
        assert leaf.dtype == torch.bfloat16, k
    assert torch.all(mine["blocks"]["ln1_scale"] == 1)
    assert torch.all(mine["blocks"]["qkv_b"] == 0)
    assert deepspeed_tpu_torch.models.get_model("bloom-7b1").name == \
        "bloom-30l-4096d"
