"""The PyTorch port's llama family (``deepspeed_tpu_torch/models/llama.py``)
against the JAX package's (``deepspeed_tpu/models/llama.py``), on the CPU.

 - ``params_from_jax`` carries the JAX tree over leaf for leaf;
 - ``forward`` logits and the loss at fp32 within 1e-4 (``tiny()``);
 - ``forward_cached`` within 1e-4, contiguous (ragged prefill, per-row
   decode) and paged (chunked-prefill bases with pads, per-row decode, the
   all-position verify window), the caches and pools written alike;
 - greedy ``generate`` and ``serve`` token-exact against the JAX engine
   and server at fp32, and under ``quantize="w8a8+kv8"`` with the w8a8
   records bit for bit;
 - a GQA config at head dim 128 (1 layer, hidden 512, 4 heads over 1 KV
   head, FFN 14336, vocab 512): its ``w2`` is 112 k-groups of 128, so
   ``w8a8+kv8`` serving reaches the long-K w8a8 route and the D = 128
   decode attention through their plain versions, token-exact against the
   JAX server (whose Pallas kernels run in interpret mode);
 - ``get_model`` names, the refused options, and the engine's default
   weights (drawn in the serving dtype, the same seed every time).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import Request as JRequest
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import paged_kv as jpk
from deepspeed_tpu_torch.inference.serving import Request
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops import paged_kv as tpk
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_KW = dict(slots=3, max_seq_len=64, block_size=8, prefill_chunk=16,
                prefill_batch=2)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def gqa128_configs():
    """The head-dim-128 GQA config, in both packages."""
    kw = dict(vocab_size=512, max_seq_len=128, num_layers=1, num_heads=4,
              num_kv_heads=1, hidden_size=512, ffn_size=14336,
              rope_theta=500000.0, remat=False)
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(JAX config, port config, JAX params as numpy, port params): the
    JAX initializer's shapes, drawn with numpy from a seed (std 0.02, the
    norm scales near 1)."""
    if name == "tiny":
        jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    else:
        jcfg, tcfg = gqa128_configs()
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jllama.init_params(jcfg, key),
                            jax.random.PRNGKey(0))

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                ((1.0 if k.endswith("norm") else 0.0) +
                 (0.1 if k.endswith("norm") else 0.02) *
                 rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    jp = draw(shapes)
    return jcfg, tcfg, jp, tllama.params_from_jax(jp)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_params_from_jax_carries_every_leaf():
    _, tcfg, jp, tp = _weights("tiny")
    want = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    # the port's own initializer draws the same shapes, in the asked dtype
    mine = tllama.init_params(tcfg, torch.Generator().manual_seed(1),
                              dtype=torch.bfloat16)
    for path, leaf in _leaves(mine):
        assert tuple(leaf.shape) == want[path].shape, path
        assert leaf.dtype == torch.bfloat16, path


def test_forward_logits_and_loss_match_jax():
    jcfg, tcfg, jp, tp = _weights("tiny")
    ids = np.random.default_rng(1).integers(0, 512, (2, 12))
    want = np.asarray(jllama.forward(jcfg, jp, jnp.asarray(ids)))
    got = tllama.forward(tcfg, tp, _t(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    labels = ids[:, 1:].copy()
    labels[0, :3] = -100
    batch = {"input_ids": ids[:, :-1], "labels": labels}
    jloss = float(jllama.loss_from_batch(jcfg, jp, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    tloss = tllama.loss_from_batch(tcfg, tp, {k: _t(v)
                                              for k, v in batch.items()})
    np.testing.assert_allclose(tloss.item(), jloss, **TOL)
    # remat recomputes each block in the backward pass: the same loss and
    # gradients as without it
    import dataclasses

    rcfg = dataclasses.replace(tcfg, remat=True)
    grads = []
    for cfg in (tcfg, rcfg):
        p = {"embed": tp["embed"].clone().requires_grad_(),
             **{k: v for k, v in tp.items() if k != "embed"}}
        loss = tllama.loss_from_batch(cfg, p, (_t(ids[:, :-1]),
                                               _t(labels)))
        loss.backward()
        grads.append((loss.detach(), p["embed"].grad))
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-6, rtol=0)


def test_forward_cached_contiguous_matches_jax():
    """Ragged right-padded prefill (logits at each row's ``lengths - 1``),
    then per-row decode steps at ``lengths``; logits and caches."""
    jcfg, tcfg, jp, tp = _weights("tiny")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (3, 8))
    lengths = np.array([8, 5, 3], np.int32)
    jc = jllama.init_cache(jcfg, 3, 32, jnp.float32)
    tc = tllama.init_cache(tcfg, 3, 32, torch.float32)
    jl, jc = jllama.forward_cached(jcfg, jp, jnp.asarray(ids), jc, 0,
                                   lengths=jnp.asarray(lengths))
    tl, tc = tllama.forward_cached(tcfg, tp, _t(ids), tc, 0,
                                   lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for step in range(3):
        nxt = np.asarray(jl).argmax(-1)[:, None]
        jl, jc = jllama.forward_cached(jcfg, jp, jnp.asarray(nxt), jc, 0,
                                       lengths=jnp.asarray(lengths))
        tl, tc = tllama.forward_cached(tcfg, tp, _t(nxt), tc, 0,
                                       lengths=_t(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        lengths = lengths + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    # a shared int position (generate's steps) at pos 8 of row 0's cache
    jl, _ = jllama.forward_cached(jcfg, jp, jnp.asarray(ids[:, :1]), jc, 11)
    tl, _ = tllama.forward_cached(tcfg, tp, _t(ids[:, :1]), tc, 11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kv8", [False, True])
def test_forward_cached_paged_matches_jax(kv8):
    """Chunked prefill with per-row window bases and pads (``pos`` int32
    [B], ``lengths`` the real tokens), a per-row decode step, then the
    all-position verify window; logits and the pool (float or int8
    records) written alike."""
    jcfg, tcfg, jp, tp = _weights("tiny")
    rng = np.random.default_rng(3)
    b, bs, nbper = 3, 4, 6
    nb = 1 + b * nbper
    bt = rng.permutation(np.arange(1, nb)).reshape(b, nbper).astype(np.int32)
    jpool = jllama.init_cache(jcfg, nb, bs, jnp.float32)
    tpool = tllama.init_cache(tcfg, nb, bs, torch.float32)
    if kv8:
        jpool = {k: jpk.quantize_pool(v) for k, v in jpool.items()}
        tpool = tpk.quantize_pool(tpool)
    jbt, tbt = jnp.asarray(bt), _t(bt)

    def both(ids, pos, lengths=None, all_positions=False):
        nonlocal jpool, tpool
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
        jl, jpool = jllama.forward_cached(
            jcfg, jp, jnp.asarray(ids), jpool, jpos,
            lengths=None if lengths is None else jnp.asarray(lengths),
            block_tables=jbt, all_positions=all_positions)
        tl, tpool = tllama.forward_cached(
            tcfg, tp, _t(ids), tpool, tpos,
            lengths=None if lengths is None else _t(lengths),
            block_tables=tbt, all_positions=all_positions)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        return np.asarray(jl)

    # two prefill chunks of 4: row 2's second chunk holds 1 real token
    ids = rng.integers(0, 512, (3, 8))
    both(ids[:, :4], np.zeros(3, np.int32), np.array([4, 4, 4], np.int32))
    logits = both(ids[:, 4:], np.full(3, 4, np.int32),
                  np.array([4, 3, 1], np.int32))
    lengths = np.array([8, 7, 5], np.int32)
    nxt = logits.argmax(-1)[:, None]
    both(nxt, 0, lengths)
    window = rng.integers(0, 512, (3, 3))
    both(window, lengths + 1, np.full(3, 3, np.int32), all_positions=True)
    for key in ("k", "v"):
        got, want = _np(tpool[key]), _np(jpool[key])
        if kv8:
            np.testing.assert_array_equal(got["qp"][1:], want["qp"][1:])
            np.testing.assert_allclose(got["ps"][1:], want["ps"][1:],
                                       **TOL)
        else:
            np.testing.assert_allclose(got[1:], want[1:], **TOL)


def _trace(vocab, n=4, seed=4, max_new=8):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 10)
    return [(i, np.concatenate([prefix, rng.integers(0, vocab,
                                                     int(rng.integers(3, 9)))]),
             int(rng.integers(3, max_new))) for i in range(n)]


def _servers(name, quantize):
    """A JAX and a port server over the same fp32 weights."""
    jcfg, tcfg, jp, tp = _weights(name)
    deepspeed_tpu.comm.reset_topology()
    jsrv = deepspeed_tpu.init_serving(
        jllama.build(jcfg), params=jp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, **SERVE_KW)
    tsrv = deepspeed_tpu_torch.init_serving(
        tllama.build(tcfg), params=tp, config={"dtype": "fp32"},
        quantize=quantize, sampling=False, device="cpu", **SERVE_KW)
    return jsrv, tsrv


def _serve_both(jsrv, tsrv, vocab, n=4, max_new=8):
    trace = _trace(vocab, n=n, max_new=max_new)
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace])
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace])
    for u, _, _ in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
    st, jst = tsrv.stats(), jsrv.stats()
    for key in ("quantize", "kv_dtype", "weight_quant", "kv_pool_bytes",
                "prefix_hit_tokens", "decode_steps", "prefill_calls"):
        assert st[key] == jst[key], key
    return trace, got


def _records_equal(tsrv, jsrv):
    """The w8a8 engines' block records, bit for bit."""
    tb, jb = tsrv.engine.params["blocks"], jax.device_get(
        jsrv.engine.params["blocks"])
    assert set(tb) == set(jb)
    for name, leaf in tb.items():
        if tq.is_k_quantized(leaf):
            for k in ("qk", "kscale"):
                np.testing.assert_array_equal(leaf[k].numpy(),
                                              np.asarray(jb[name][k]))
        else:
            np.testing.assert_array_equal(_np(leaf), np.asarray(jb[name]))
    return [n for n, leaf in tb.items() if tq.is_k_quantized(leaf)]


def test_generate_and_serve_token_exact_with_jax():
    jsrv, tsrv = _servers("tiny", None)
    # 40 prompt tokens: a prefill window sliced by 16 (windows of 16 and
    # fewer are the servers' chunks and forward_cached's tests)
    prompts = np.random.default_rng(5).integers(0, 512, (3, 40))
    want = np.asarray(jsrv.engine.generate(prompts, max_new_tokens=8))
    np.testing.assert_array_equal(
        tsrv.engine.generate(prompts, max_new_tokens=8), want)
    trace, got = _serve_both(jsrv, tsrv, 512)
    for u, p, m in trace:             # the server decodes what generate does
        np.testing.assert_array_equal(
            got[u], tsrv.engine.generate(p[None], max_new_tokens=m)[0])


def test_w8a8_kv8_serve_token_exact_with_jax():
    jsrv, tsrv = _servers("tiny", "w8a8+kv8")
    assert _records_equal(tsrv, jsrv) == []     # hidden 64: no whole group
    _serve_both(jsrv, tsrv, 512)


def test_gqa128_long_k_serve_token_exact_with_jax():
    """Head dim 128, GQA rep 4, ``w2`` at 112 k-groups: ``w8a8+kv8``
    serving token-exact with the JAX server (the float D = 128 route is
    held by the attention tests and the tiny config's servers)."""
    from deepspeed_tpu_torch.ops import quantized_matmul as tqm

    jsrv, tsrv = _servers("gqa128", "w8a8+kv8")
    quantized = _records_equal(tsrv, jsrv)
    assert sorted(quantized) == ["k_w", "o_w", "q_w", "v_w", "w1", "w2",
                                 "w3"]
    w2 = tsrv.engine.params["blocks"]["w2"]
    groups = w2["kscale"].shape[1]
    assert groups == 112 and tqm.w8a8_groups_per_block(groups) == 7
    _serve_both(jsrv, tsrv, 512, n=1, max_new=4)


def test_engine_quantizes_layer_by_layer_to_the_whole_stack_records():
    """The engine's per-layer quantization on its device gives the records
    of the whole stack quantized at once, w8a8 and weight-only."""
    _, tcfg, _, tp = _weights("gqa128")
    blocks = {k: v.clone() for k, v in tp["blocks"].items()}
    for fn, kw in ((tq.quantize_pytree_k_grouped, dict(k_group=128)),
                   (tq.quantize_pytree, dict(group_size=128))):
        whole = fn(blocks, min_ndim=3, **kw)
        by_layer = fn(blocks, min_ndim=3, device="cpu", **kw)
        for name, rec in whole.items():
            if tq.is_record(rec):
                for k in rec:
                    assert torch.equal(by_layer[name][k], rec[k]), (name, k)
            else:
                assert by_layer[name] is rec


def test_default_weights_draw_in_the_serving_dtype():
    model = tllama.build(tllama.LlamaConfig.tiny())
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                             device="cpu")
    again = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                               device="cpu")
    for (path, a), (_, b) in zip(_leaves(eng.params), _leaves(again.params)):
        assert a.dtype == torch.bfloat16, path
        assert torch.equal(a, b), path
    out = eng.generate(np.arange(6)[None], max_new_tokens=4)
    assert out.shape == (1, 10)


def test_config_refuses_the_multi_gpu_options():
    for kw in ({"scan_group_size": 2}, {"sp_impl": "ring"}):
        with pytest.raises(NotImplementedError, match=r"Queue A item 8\)"):
            tllama.LlamaConfig(**kw)
    assert tllama.LlamaConfig.llama3_8b().head_dim == 128
    cfg = tllama.LlamaConfig.llama3_70b()
    assert (cfg.num_layers, cfg.hidden_size, cfg.ffn_size) == (80, 8192,
                                                               28672)
    jcfg = jllama.LlamaConfig.llama3_8b()
    assert tllama.LlamaConfig.llama3_8b().num_params() == jcfg.num_params()


def test_prefill_windows_take_at_least_the_minimum_rows():
    """The cached path's matmuls run on fixed row counts: a prefill window
    of fewer than 256 rows on 256 (zero rows after its own, dropped from
    the result), a wider one in blocks of 256, a decode step on at least
    8 rows and never split."""
    from deepspeed_tpu_torch.utils import rows

    seen = []

    def mm(y, name, dtype):
        seen.append(tuple(y.shape))
        return y @ torch.ones(y.shape[-1], 3, dtype=y.dtype)

    prefill, _ = rows.ROWS["prefill"]
    for mode, shape, calls in (
            ("prefill", (2, 5, 4), [(prefill, 4)]),
            ("prefill", (4, 96, 4), [(prefill, 4)] * 2),
            ("decode", (3, 1, 4), [(8, 4)]),
            ("decode", (16, 1, 4), [(16, 4)])):
        y = torch.arange(math.prod(shape), dtype=torch.float64) \
            .reshape(shape)
        seen.clear()
        out = rows.fixed_row_mm(mm, mode)(y, "w", None)
        assert seen == calls
        assert torch.equal(out, y @ torch.ones(4, 3, dtype=y.dtype))


def test_decode_over_layers_refuses_a_stack_of_another_depth():
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    _, tcfg, _, tp = _weights("tiny")
    cache = tllama.init_cache(tcfg, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="carry 2 layers but num_layers=3"):
        tgpt2.decode_over_layers(lambda x, *a: x, torch.zeros(1, 1, 64),
                                 tp["blocks"], cache["k"], cache["v"], 3,
                                 probe="q_w")

