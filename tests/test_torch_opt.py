"""The PyTorch port's OPT family (``deepspeed_tpu_torch/models/opt.py``)
against the JAX package's (``deepspeed_tpu/models/opt.py``), on the CPU at
fp32.

 - ``forward`` logits and the loss within 1e-4 for pre-LN (125m-like),
   post-LN, and post-LN with ``project_in``/``project_out`` (350m-like);
 - ``forward_cached``: contiguous ragged prefill, per-row decode, paged
   chunks with per-row bases and pads, the verify window, and a window
   whose learned positions clamp at the table's end;
 - greedy ``generate`` and ``serve`` token-exact against the JAX engine
   and server, and under ``w8a8+kv8`` with the records bit for bit;
 - ``from_hf_state_dict`` equal to JAX's on a random numpy state dict;
 - ``get_model`` names and the named configs' sizes.
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
from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu_torch.inference.serving import Request
from deepspeed_tpu_torch.models import opt as topt
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_KW = dict(slots=3, max_seq_len=64, block_size=8, prefill_chunk=16,
                prefill_batch=2)
VARIANTS = {
    "pre_ln": {},
    "post_ln": dict(do_layer_norm_before=False),
    "proj": dict(do_layer_norm_before=False, word_embed_proj_dim=32),
    # whole k-groups of 128 and 128-column N: w8a8 quantizes every matrix
    "wide": dict(num_heads=2, hidden_size=128, ffn_size=256),
}


def _configs(name):
    kw = VARIANTS[name]
    return (dataclasses.replace(jopt.OPTConfig.tiny(), **kw),
            dataclasses.replace(topt.OPTConfig.tiny(), **kw))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(JAX config, port config, JAX params as numpy, port params): the
    JAX initializer's shapes drawn with numpy from a seed (biases and LN
    parameters nonzero, so each one is held)."""
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jopt.init_params(jcfg, key),
                            jax.random.PRNGKey(0))

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                ((1.0 if "scale" in k else 0.0) +
                 (0.1 if ("scale" in k or "_b" in k) else 0.05) *
                 rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    jp = draw(shapes)
    return jcfg, tcfg, jp, topt.params_from_jax(jp)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", ["pre_ln", "post_ln", "proj"])
def test_forward_and_loss_match_jax(name):
    jcfg, tcfg, jp, tp = _weights(name)
    assert set(tp) == set(jp)
    ids = np.random.default_rng(1).integers(0, 512, (2, 12))
    want = np.asarray(jopt.forward(jcfg, jp, jnp.asarray(ids)))
    np.testing.assert_allclose(topt.forward(tcfg, tp, _t(ids)).numpy(),
                               want, **TOL)
    labels = ids[:, 1:].copy()
    labels[1, :4] = -100
    jloss = jopt.loss_from_batch(jcfg, jp, (jnp.asarray(ids[:, :-1]),
                                            jnp.asarray(labels)))
    tloss = topt.loss_from_batch(tcfg, tp, (_t(ids[:, :-1]), _t(labels)))
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("name", ["pre_ln", "proj"])
def test_forward_cached_matches_jax(name):
    jcfg, tcfg, jp, tp = _weights(name)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (3, 8))
    lengths = np.array([8, 6, 2], np.int32)
    jc = jopt.init_cache(jcfg, 3, 128, jnp.float32)
    tc = topt.init_cache(tcfg, 3, 128, torch.float32)
    jl, jc = jopt.forward_cached(jcfg, jp, jnp.asarray(ids), jc, 0,
                                 lengths=jnp.asarray(lengths))
    tl, tc = topt.forward_cached(tcfg, tp, _t(ids), tc, 0,
                                 lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(2):
        nxt = np.asarray(jl).argmax(-1)[:, None]
        jl, jc = jopt.forward_cached(jcfg, jp, jnp.asarray(nxt), jc, 0,
                                     lengths=jnp.asarray(lengths))
        tl, tc = topt.forward_cached(tcfg, tp, _t(nxt), tc, 0,
                                     lengths=_t(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        lengths = lengths + 1
    # a shared position whose window runs past the table: the start clamps
    # (lax.dynamic_slice), per-row positions past it clip (each on a copy:
    # the port writes its cache in place)
    jl, _ = jopt.forward_cached(jcfg, jp, jnp.asarray(ids[:, :4]), jc, 62)
    tl, _ = topt.forward_cached(tcfg, tp, _t(ids[:, :4]),
                                {k: v.clone() for k, v in tc.items()}, 62)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    far = np.array([63, 70, 5], np.int32)
    jl, _ = jopt.forward_cached(jcfg, jp, jnp.asarray(ids[:, :1]), jc, 0,
                                lengths=jnp.asarray(far))
    tl, _ = topt.forward_cached(tcfg, tp, _t(ids[:, :1]),
                                {k: v.clone() for k, v in tc.items()}, 0,
                                lengths=_t(far))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    b, bs, nbper = 3, 4, 6
    nb = 1 + b * nbper
    bt = rng.permutation(np.arange(1, nb)).reshape(b, nbper).astype(np.int32)
    jpool = jopt.init_cache(jcfg, nb, bs, jnp.float32)
    tpool = topt.init_cache(tcfg, nb, bs, torch.float32)

    def both(ids, pos, lens, all_positions=False):
        nonlocal jpool, tpool
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
        jl, jpool = jopt.forward_cached(
            jcfg, jp, jnp.asarray(ids), jpool, jpos,
            lengths=jnp.asarray(lens), block_tables=jnp.asarray(bt),
            all_positions=all_positions)
        tl, tpool = topt.forward_cached(
            tcfg, tp, _t(ids), tpool, tpos, lengths=_t(lens),
            block_tables=_t(bt), all_positions=all_positions)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        return np.asarray(jl)

    ids = rng.integers(0, 512, (3, 8))
    both(ids[:, :4], np.zeros(3, np.int32), np.array([4, 4, 4], np.int32))
    logits = both(ids[:, 4:], np.full(3, 4, np.int32),
                  np.array([4, 3, 1], np.int32))
    lens = np.array([8, 7, 5], np.int32)
    both(logits.argmax(-1)[:, None], 0, lens)
    both(rng.integers(0, 512, (3, 3)), lens + 1, np.full(3, 3, np.int32),
         all_positions=True)
    for key in ("k", "v"):
        np.testing.assert_allclose(tpool[key][1:].numpy(),
                                   np.asarray(jpool[key])[1:], **TOL)


def _trace(vocab, n=4, seed=4, max_new=8):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 10)
    return [(i, np.concatenate([prefix, rng.integers(0, vocab,
                                                     int(rng.integers(3, 12)))]),
             int(rng.integers(3, max_new))) for i in range(n)]


def _servers(name, quantize=None):
    jcfg, tcfg, jp, tp = _weights(name)
    deepspeed_tpu.comm.reset_topology()
    jsrv = deepspeed_tpu.init_serving(
        jopt.build(jcfg), params=jp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, **SERVE_KW)
    tsrv = deepspeed_tpu_torch.init_serving(
        topt.build(tcfg), params=tp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, device="cpu", **SERVE_KW)
    return jsrv, tsrv


def _serve_both(jsrv, tsrv, n=4):
    trace = _trace(512, n=n)
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace])
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace])
    for u, _, _ in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
    st, jst = tsrv.stats(), jsrv.stats()
    for key in ("quantize", "kv_dtype", "weight_quant", "kv_pool_bytes",
                "prefix_hit_tokens", "decode_steps", "prefill_calls"):
        assert st[key] == jst[key], key
    return trace, got


@pytest.mark.parametrize("name", ["pre_ln", "proj"])
def test_generate_and_serve_token_exact_with_jax(name):
    jsrv, tsrv = _servers(name)
    prompts = np.random.default_rng(5).integers(0, 512, (2, 21))
    want = np.asarray(jsrv.engine.generate(prompts, max_new_tokens=6))
    np.testing.assert_array_equal(
        tsrv.engine.generate(prompts, max_new_tokens=6), want)
    trace, got = _serve_both(jsrv, tsrv)
    for u, p, m in trace:
        np.testing.assert_array_equal(
            got[u], tsrv.engine.generate(p[None], max_new_tokens=m)[0])


def test_w8a8_kv8_serve_token_exact_with_jax():
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
    _serve_both(jsrv, tsrv, n=3)


def test_from_hf_state_dict_matches_jax():
    """A random numpy state dict under HF OPT names (350m-like: post-LN,
    projections; and pre-LN with the ``model.decoder.`` prefix)."""
    for name, prefix in (("proj", ""), ("pre_ln", "model.decoder.")):
        jcfg, tcfg = _configs(name)
        rng = np.random.default_rng(7)
        d, f, e = tcfg.hidden_size, tcfg.ffn_size, tcfg.embed_dim

        def n(*shape):
            return rng.standard_normal(shape).astype(np.float32)

        sd = {"embed_tokens.weight": n(tcfg.vocab_size, e),
              "embed_positions.weight": n(tcfg.max_seq_len + 2, d)}
        for i in range(tcfg.num_layers):
            p = f"layers.{i}."
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[p + f"self_attn.{proj}.weight"] = n(d, d)
                sd[p + f"self_attn.{proj}.bias"] = n(d)
            for ln in ("self_attn_layer_norm", "final_layer_norm"):
                sd[p + f"{ln}.weight"] = n(d)
                sd[p + f"{ln}.bias"] = n(d)
            sd[p + "fc1.weight"], sd[p + "fc1.bias"] = n(f, d), n(f)
            sd[p + "fc2.weight"], sd[p + "fc2.bias"] = n(d, f), n(d)
        if tcfg.do_layer_norm_before:
            sd["final_layer_norm.weight"] = n(d)
            sd["final_layer_norm.bias"] = n(d)
        if tcfg.has_proj:
            sd["project_in.weight"] = n(d, e)
            sd["project_out.weight"] = n(e, d)
        sd = {prefix + k: v for k, v in sd.items()}
        want = jax.device_get(jopt.from_hf_state_dict(jcfg, sd))
        got = topt.from_hf_state_dict(tcfg, sd)
        assert set(got) == set(want)
        for k, v in got.items():
            if k == "blocks":
                assert set(v) == set(want[k])
                for bk, bv in v.items():
                    np.testing.assert_array_equal(bv.numpy(), want[k][bk])
            else:
                np.testing.assert_array_equal(v.numpy(), want[k])
        # torch tensors in, the same tree out
        tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
        again = topt.from_hf_state_dict(tcfg, tsd)
        assert torch.equal(again["blocks"]["qkv_w"], got["blocks"]["qkv_w"])


def test_named_configs_and_draws():
    for fn in ("opt_125m", "opt_350m", "opt_1_3b", "opt_2_7b", "opt_6_7b",
               "opt_13b", "opt_30b", "opt_66b"):
        j, t = getattr(jopt.OPTConfig, fn)(), getattr(topt.OPTConfig, fn)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t), fn
        assert j.num_params() == t.num_params(), fn
    cfg = topt.OPTConfig.opt_13b()
    assert (cfg.head_dim, cfg.num_heads, cfg.ffn_size) == (128, 40, 20480)
    _, tcfg, jp, _ = _weights("proj")
    mine = topt.init_params(tcfg, torch.Generator().manual_seed(1),
                            dtype=torch.bfloat16)
    assert set(mine) == set(jp)
    for k, leaf in mine["blocks"].items():
        assert tuple(leaf.shape) == jp["blocks"][k].shape, k
        assert leaf.dtype == torch.bfloat16, k
    assert torch.all(mine["blocks"]["ln1_scale"] == 1)
    assert torch.all(mine["blocks"]["qkv_b"] == 0)
