"""The PyTorch port's Mixtral (``deepspeed_tpu_torch/models/mixtral.py``)
against the JAX package's (``deepspeed_tpu/models/mixtral.py``), on the
CPU at fp32.

Two configs: ``tiny()`` (4 experts, whose default capacity never drops a
top-2 choice) and ``drops``: tiny with 8 experts and
``eval_capacity_factor=0.5``, so every prefill window drops tokens and a
token routed in the wrong group (another window, other pads, a verify
window split into positions) changes the logits and the served tokens.

 - ``params_from_jax`` carries every leaf; ``forward_with_aux`` logits and
   aux within 1e-4, and ``loss_from_batch``;
 - ``forward_cached`` prefill (contiguous, and paged chunks with per-row
   bases and pads) and per-row decode within 1e-4, and the verify window;
 - greedy ``generate`` and ``serve`` token-exact against the JAX engine
   and server; ``w8a8+kv8`` with the expert records bit for bit (the
   router stays dense) and tokens exact; an n-gram ``spec_tokens=4``
   trace token-exact with the JAX server's spec counters;
 - the engine's layer-by-layer quantized default draw gives the records
   of quantizing the whole drawn stack, and the depth prefix property.
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
from deepspeed_tpu.models import mixtral as jmix
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.ops import paged_kv as jpk
from deepspeed_tpu_torch.inference.serving import Request
from deepspeed_tpu_torch.models import mixtral as tmix
from deepspeed_tpu_torch.ops import paged_kv as tpk
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_KW = dict(slots=3, max_seq_len=64, block_size=8, prefill_chunk=16,
                prefill_batch=2)
_COUNTERS = ("spec_rounds", "drafted_tokens", "accepted_tokens",
             "spec_draft_rejected", "acceptance_rate", "decode_steps",
             "prefill_calls", "prefix_hit_tokens")


def _configs(name):
    if name == "tiny":
        return jmix.MixtralConfig.tiny(), tmix.MixtralConfig.tiny()
    if name == "drops":
        kw = dict(num_experts=8, eval_capacity_factor=0.5)
        return (dataclasses.replace(jmix.MixtralConfig.tiny(), **kw),
                dataclasses.replace(tmix.MixtralConfig.tiny(), **kw))
    # 256 wide, GQA 4/2: whole k-groups and 128-column N, so w8a8
    # quantizes the attention and the experts (the router's N = 4 stays
    # dense)
    kw = dict(vocab_size=512, max_seq_len=128, num_layers=2, num_heads=4,
              num_kv_heads=2, hidden_size=256, ffn_size=128,
              rope_theta=10000.0, num_experts=4, remat=False)
    return jmix.MixtralConfig(**kw), tmix.MixtralConfig(**kw)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(JAX config, port config, JAX params as numpy, port params): the
    JAX initializer's shapes drawn with numpy from a seed (std 0.05, the
    norm scales near 1)."""
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jmix.init_params(jcfg, key),
                            jax.random.PRNGKey(0))

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                ((1.0 if k.endswith("norm") else 0.0) +
                 (0.1 if k.endswith("norm") else 0.05) *
                 rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    jp = draw(shapes)
    return jcfg, tcfg, jp, tmix.params_from_jax(jp)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def test_params_from_jax_and_init_params_shapes():
    _, tcfg, jp, tp = _weights("tiny")
    assert set(tp) == set(jp) and set(tp["blocks"]) == set(jp["blocks"])
    for k, leaf in tp["blocks"].items():
        np.testing.assert_array_equal(leaf.numpy(), jp["blocks"][k])
    mine = tmix.init_params(tcfg, torch.Generator().manual_seed(1),
                            dtype=torch.bfloat16)
    for k, leaf in mine["blocks"].items():
        assert tuple(leaf.shape) == jp["blocks"][k].shape, k
        assert leaf.dtype == torch.bfloat16, k
    # layer after layer: num_layers draws the config's first layers
    cfg3 = dataclasses.replace(tcfg, num_layers=3)
    deep = tmix.init_params(cfg3, torch.Generator().manual_seed(1))
    flat = tmix.init_params(cfg3, torch.Generator().manual_seed(1),
                            num_layers=2)
    for k in ("embed", "lm_head"):
        assert torch.equal(deep[k], flat[k])
    for k, leaf in flat["blocks"].items():
        assert torch.equal(deep["blocks"][k][:2], leaf), k


@pytest.mark.parametrize("name", ["tiny", "drops"])
def test_forward_with_aux_and_loss_match_jax(name):
    jcfg, tcfg, jp, tp = _weights(name)
    ids = np.random.default_rng(1).integers(0, 512, (2, 12))
    for train in (True, False):
        jl, jaux = jmix.forward_with_aux(jcfg, jp, jnp.asarray(ids),
                                         train=train)
        tl, taux = tmix.forward_with_aux(tcfg, tp, _t(ids), train=train)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    labels = ids[:, 1:].copy()
    labels[0, :2] = -100
    jloss = jmix.loss_from_batch(jcfg, jp, (jnp.asarray(ids[:, :-1]),
                                            jnp.asarray(labels)))
    tloss = tmix.loss_from_batch(tcfg, tp, (_t(ids[:, :-1]), _t(labels)))
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)


def test_drops_config_drops_tokens():
    """The ``drops`` config's first layer drops choices in a 16-token
    window (checked on the JAX gating of its router logits)."""
    jcfg, _, jp, _ = _weights("drops")
    y = np.random.default_rng(9).standard_normal((1, 16, 64)) \
        .astype(np.float32)
    logits = y @ jp["blocks"]["gate_w"][0]
    _, _, _, counts = jmoe.top2gating(jnp.asarray(logits),
                                      jcfg.eval_capacity_factor)
    assert int(np.asarray(counts).sum()) < 2 * 16


@pytest.mark.parametrize("name", ["tiny", "drops"])
def test_forward_cached_matches_jax(name):
    """Contiguous: a ragged prefill then per-row decode steps; paged: two
    chunks with per-row bases and pads, a decode step and a verify window
    (gated as one group); logits within 1e-4 and the pools alike."""
    jcfg, tcfg, jp, tp = _weights(name)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (3, 8))
    lengths = np.array([8, 5, 3], np.int32)
    jc = jmix.L.init_cache(jcfg, 3, 32, jnp.float32)
    tc = tmix.L.init_cache(tcfg, 3, 32, torch.float32)
    jl, jc = jmix.forward_cached(jcfg, jp, jnp.asarray(ids), jc, 0,
                                 lengths=jnp.asarray(lengths))
    tl, tc = tmix.forward_cached(tcfg, tp, _t(ids), tc, 0,
                                 lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1)[:, None]
        jl, jc = jmix.forward_cached(jcfg, jp, jnp.asarray(nxt), jc, 0,
                                     lengths=jnp.asarray(lengths))
        tl, tc = tmix.forward_cached(tcfg, tp, _t(nxt), tc, 0,
                                     lengths=_t(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        lengths = lengths + 1

    b, bs, nbper = 3, 4, 6
    nb = 1 + b * nbper
    bt = rng.permutation(np.arange(1, nb)).reshape(b, nbper).astype(np.int32)
    jpool = {k: jpk.quantize_pool(v) for k, v in
             jmix.L.init_cache(jcfg, nb, bs, jnp.float32).items()}
    tpool = tpk.quantize_pool(tmix.L.init_cache(tcfg, nb, bs, torch.float32))

    def both(ids, pos, lens, all_positions=False):
        nonlocal jpool, tpool
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
        jl, jpool = jmix.forward_cached(
            jcfg, jp, jnp.asarray(ids), jpool, jpos,
            lengths=jnp.asarray(lens), block_tables=jnp.asarray(bt),
            all_positions=all_positions)
        tl, tpool = tmix.forward_cached(
            tcfg, tp, _t(ids), tpool, tpos, lengths=_t(lens),
            block_tables=_t(bt), all_positions=all_positions)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        return np.asarray(jl)

    ids = rng.integers(0, 512, (3, 16))
    both(ids[:, :8], np.zeros(3, np.int32), np.array([8, 8, 8], np.int32))
    logits = both(ids[:, 8:], np.full(3, 8, np.int32),
                  np.array([8, 5, 1], np.int32))
    lens = np.array([16, 13, 9], np.int32)
    both(logits.argmax(-1)[:, None], 0, lens)
    both(rng.integers(0, 512, (3, 5)), lens + 1, np.full(3, 5, np.int32),
         all_positions=True)
    for key in ("k", "v"):
        got, want = _np(tpool[key]), _np(jpool[key])
        # int8 codes of f32 values that agree to ~1e-7: a code at a
        # rounding boundary may land one step away
        diff = np.abs(got["qp"][1:].astype(np.int32) - want["qp"][1:])
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
        np.testing.assert_allclose(got["ps"][1:], want["ps"][1:], **TOL)


def _trace(vocab, n=4, seed=4, max_new=8):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 10)
    return [(i, np.concatenate([prefix, rng.integers(0, vocab,
                                                     int(rng.integers(3, 12)))]),
             int(rng.integers(3, max_new))) for i in range(n)]


def _servers(name, quantize=None, **kw):
    jcfg, tcfg, jp, tp = _weights(name)
    deepspeed_tpu.comm.reset_topology()
    kw = {**SERVE_KW, **kw}
    jsrv = deepspeed_tpu.init_serving(
        jmix.build(jcfg), params=jp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, **kw)
    tsrv = deepspeed_tpu_torch.init_serving(
        tmix.build(tcfg), params=tp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, device="cpu", **kw)
    return jsrv, tsrv


def _serve_both(jsrv, tsrv, vocab=512, **kw):
    trace = _trace(vocab, **kw)
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace])
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace])
    for u, _, _ in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
    st, jst = tsrv.stats(), jsrv.stats()
    for key in ("quantize", "kv_dtype", "weight_quant", "kv_pool_bytes",
                "prefix_hit_tokens", "decode_steps", "prefill_calls"):
        assert st[key] == jst[key], key
    return trace, got


@pytest.mark.parametrize("name", ["tiny", "drops"])
def test_generate_and_serve_token_exact_with_jax(name):
    """``generate`` routes the prompt as one group, the server each
    16-token window (pads included) as one: both token-exact with the
    JAX engine and server."""
    jsrv, tsrv = _servers(name)
    prompts = np.random.default_rng(5).integers(0, 512, (2, 21))
    want = np.asarray(jsrv.engine.generate(prompts, max_new_tokens=6))
    np.testing.assert_array_equal(
        tsrv.engine.generate(prompts, max_new_tokens=6), want)
    _serve_both(jsrv, tsrv)


def test_w8a8_kv8_serve_token_exact_with_jax():
    """The expert stacks ``[L, E, K, N]`` become K-grouped records with
    the attention projections (the router ``[L, D, E]`` stays dense), bit
    for bit the JAX engine's; served tokens equal."""
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
            np.testing.assert_array_equal(_np(leaf), np.asarray(jb[name]))
    assert sorted(quantized) == ["experts_w1", "experts_w2", "experts_w3",
                                 "k_w", "o_w", "q_w", "v_w"]
    assert tb["experts_w1"]["kscale"].shape == (2, 4, 2, 1, 128)
    _serve_both(jsrv, tsrv, n=3)


def test_ngram_spec_token_exact_with_jax():
    """``spec_tokens=4`` with the n-gram proposer: each verify window of 5
    is gated as one group (the port's attention projections run it one
    position at a time); tokens and spec counters equal the JAX
    server's."""
    jsrv, tsrv = _servers("drops", spec_tokens=4, slots=4, max_seq_len=128)
    rng = np.random.default_rng(6)
    base = rng.integers(0, 512, 6)
    trace = [(i, np.concatenate([np.tile(base, 3), rng.integers(0, 512, 3)]),
              12) for i in range(4)]
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace])
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace])
    for u, _, _ in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
    js, ts = jsrv.stats(), tsrv.stats()
    assert {k: ts[k] for k in _COUNTERS} == {k: js[k] for k in _COUNTERS}
    assert ts["spec_rounds"] > 0 and ts["drafted_tokens"] > 0


def test_engine_draws_quantized_layer_by_layer():
    """With ``quant`` on and no params, the engine quantizes each layer as
    it is drawn: the records equal those of the whole bf16 draw quantized
    by the engine, for w8a8 and weight-only."""
    _, tcfg, _, _ = _weights("wide")
    model = tmix.build(tcfg)
    for qtype in ("w8a8", "weight"):
        conf = {"dtype": "bf16", "quant": {"enabled": True, "type": qtype}}
        eng = deepspeed_tpu_torch.init_inference(model, config=conf,
                                                 device="cpu")
        whole = tmix.init_params(tcfg, torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16)
        ref = deepspeed_tpu_torch.init_inference(model, config=conf,
                                                 params=whole, device="cpu")
        for name, leaf in ref.params["blocks"].items():
            got = eng.params["blocks"][name]
            if tq.is_record(leaf):
                assert set(got) == set(leaf), name
                for k in leaf:
                    assert torch.equal(got[k], leaf[k]), (qtype, name, k)
            else:
                assert torch.equal(got, leaf), name
        assert tq.is_record(eng.params["blocks"]["experts_w2"])
    out = eng.generate(np.arange(6)[None], max_new_tokens=3)
    assert out.shape == (1, 9)


def test_refusals():
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        deepspeed_tpu_torch.init_inference(
            tmix.build(tmix.MixtralConfig.tiny()),
            config={"dtype": "fp32", "moe": {"ep_size": 2}}, device="cpu")
    cfg = tmix.MixtralConfig.mixtral_8x7b()
    assert cfg.num_params() == jmix.MixtralConfig.mixtral_8x7b().num_params()
    assert tmix.build(cfg).flops_per_token == \
        jmix.build(jmix.MixtralConfig.mixtral_8x7b()).flops_per_token
