"""Block-sparse attention, the port (``deepspeed_tpu_torch/ops/
sparse_attention``, the layout keyword of ``ops/flash_attention.py``)
against the JAX package (``deepspeed_tpu/ops/sparse_attention``, whose
``sparse_attention`` runs the v1 Pallas kernels with their layout gate, in
interpret mode on the CPU as the JAX package's own tests run them).

- The six sparsity configs give the JAX layouts bit for bit (random blocks
  and per-head patterns included).
- The plain forward with a layout against JAX ``sparse_attention`` and the
  v1 ``_fwd`` with its layout: fp32 o and lse within 1e-5 (both sum in
  other orders); grads through ``torch.autograd`` (``_SparseAttention``)
  against ``jax.grad`` within 1e-4, GQA included.
- A layout row with no block: o = 0 exactly, lse = -inf, dq = 0, no NaN,
  as the JAX kernel gives (the dense reference averages v there).
- The CUDA kernels' tile maps against a brute-force ``any()`` / ``all()``
  over the mask expanded from the layout with ``np.kron``, for the three
  bf16 tile shapes and 64 x 64, blocks 16 to 256, ragged S and GQA.
- bf16: the plain forward and the tiled backward models with a layout
  against JAX's bf16 kernels at ``chip_smoke.py``'s phase-2b bars.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    sparse_attention_reference)

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# (config class name, constructor keywords, sequence length)
CONFIGS = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    ("FixedSparsityConfig", dict(num_heads=2, block=16), 256),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=4,
                                 num_global_blocks=1,
                                 attention="unidirectional"), 256),
    ("FixedSparsityConfig", dict(num_heads=4, block=32, num_local_blocks=4,
                                 num_global_blocks=1,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=4,
                                 horizontal_global_attention=True), 512),
    ("VariableSparsityConfig", dict(num_heads=3, block=16,
                                    num_random_blocks=2,
                                    local_window_blocks=[2, 4],
                                    global_block_indices=[0, 5],
                                    different_layout_per_head=True), 256),
    ("VariableSparsityConfig", dict(num_heads=2, block=16,
                                    num_random_blocks=1,
                                    global_block_indices=[1],
                                    global_block_end_indices=[3],
                                    attention="unidirectional"), 192),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16), 256),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16,
                                   num_random_blocks=2,
                                   different_layout_per_head=True), 256),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=64,
                                   attention="unidirectional"), 1024),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=128,
                                        num_sliding_window_blocks=5,
                                        global_block_indices=[0]), 2048),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                        global_block_indices=[1],
                                        global_block_end_indices=[3],
                                        attention="unidirectional"), 256),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16), 48),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16,
                                              num_sliding_window_blocks=5,
                                              attention="bidirectional"), 128),
]


@pytest.mark.parametrize("name,kw,s", CONFIGS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONFIGS)])
def test_layouts_equal_the_jax_package_bit_for_bit(name, kw, s):
    got = getattr(tsa, name)(**kw).make_layout(s)
    want = getattr(jsa, name)(**kw).make_layout(s)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_configs_refuse_what_the_jax_package_refuses():
    with pytest.raises(ValueError, match="multiple"):
        tsa.FixedSparsityConfig(num_heads=1, block=16).make_layout(40)
    with pytest.raises(AssertionError):
        tsa.FixedSparsityConfig(num_heads=2, num_different_global_patterns=2)
    with pytest.raises(NotImplementedError):
        tsa.SparsityConfig(num_heads=1).make_layout(16)


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, h, s, d)).astype(f),
            rng.standard_normal((b, hkv, s, d)).astype(f),
            rng.standard_normal((b, hkv, s, d)).astype(f),
            rng.standard_normal((b, h, s, d)).astype(f))


def _jax_fwd(q, k, v, layout, block, causal):
    """o and lse of the v1 forward with the layout, as ``sparse_attention``
    calls it (interpret mode)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    lay = jnp.broadcast_to(jnp.asarray(layout, jnp.float32),
                           (h,) + layout.shape[1:])
    o, lse = jfa._fwd(jnp.asarray(q).reshape(b * h, s, d),
                      jnp.asarray(k).reshape(b * hkv, s, d),
                      jnp.asarray(v).reshape(b * hkv, s, d),
                      1.0 / math.sqrt(d), causal, block, block, True, s,
                      h // hkv, lay)
    return (np.asarray(o.astype(jnp.float32)).reshape(q.shape),
            np.asarray(lse).reshape(b, h, s))


FWD_CASES = [
    ("BigBird bidirectional", tsa.BigBirdSparsityConfig(
        num_heads=2, block=16, num_random_blocks=1), False, 16),
    ("BigBird bidirectional", tsa.BigBirdSparsityConfig(
        num_heads=2, block=16, num_random_blocks=1), False, 64),
    ("Fixed causal", tsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional"), True, 16),
    ("Fixed causal", tsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional"), True, 64),
]


@pytest.mark.parametrize("label,cfg,causal,d", FWD_CASES,
                         ids=[f"{c[0]}-D{c[3]}" for c in FWD_CASES])
def test_plain_forward_matches_the_jax_kernel(label, cfg, causal, d):
    q, k, v, _ = _qkv(d, 1, 2, 2, 64, d)
    layout = cfg.make_layout(64)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = tfa.flash_attention_fwd_plain(
        *t, causal, layout=torch.from_numpy(layout), block=16)
    want_o, want_lse = _jax_fwd(q, k, v, layout, 16, causal)
    np.testing.assert_allclose(o.numpy(), want_o, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **FWD_TOL)
    # the public entry points: SparseSelfAttention and sparse_attention
    got = tsa.SparseSelfAttention(cfg)(*t)
    np.testing.assert_allclose(got.numpy(), want_o, **FWD_TOL)
    want = jsa.sparse_attention(*map(jnp.asarray, (q, k, v)), layout, 16,
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _grads_case(b, h, hkv, s, d, layout, causal, seed):
    q, k, v, do = _qkv(seed, b, h, hkv, s, d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tsa.sparse_attention(tq, tk, tv, layout, 16, causal=causal)
    out.backward(torch.from_numpy(do))

    def loss(q, k, v):
        o = jsa.sparse_attention(q, k, v, layout, 16, causal=causal)
        return (o * jnp.asarray(do)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_grads_match_jax_local_sliding_window_s48():
    layout = tsa.LocalSlidingWindowSparsityConfig(
        num_heads=2, block=16, num_sliding_window_blocks=3).make_layout(48)
    _grads_case(1, 2, 2, 48, 16, layout, True, 5)


def test_grads_match_jax_under_gqa():
    """The JAX package's ``test_sparse_kernel_gqa_gradients_match`` case
    (h = 4, hkv = 2, S = 48), with a layout per head so that each query
    head's dk and dv terms follow its own layout head."""
    same = tsa.LocalSlidingWindowSparsityConfig(
        num_heads=4, block=16, num_sliding_window_blocks=3).make_layout(48)
    _grads_case(1, 4, 2, 48, 16, same, True, 7)
    layout = same.copy()
    layout[1, 2, 0] = 1                  # heads 1-3 each differ from head 0
    layout[2, 1, 0] = 0
    layout[3] = np.tril(np.ones((3, 3), layout.dtype))
    _grads_case(1, 4, 2, 48, 16, layout, True, 6)


def test_an_empty_layout_row_gives_zeros_as_the_jax_kernel():
    """B=1, H=2, S=64, D=16, block 16, the second block row of head 0
    empty: o = 0 exactly there, lse = -inf, dq = 0, no NaN anywhere; the
    JAX kernel gives the same o, its dense reference an average of v."""
    q, k, v, do = _qkv(11, 1, 2, 2, 64, 16)
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=16,
                                       different_layout_per_head=True
                                       ).make_layout(64)
    layout[0, 1] = 0
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tsa.sparse_attention(tq, tk, tv, layout, 16)
    o.backward(torch.from_numpy(do))
    assert torch.equal(o[0, 0, 16:32], torch.zeros(16, 16))
    assert torch.equal(tq.grad[0, 0, 16:32], torch.zeros(16, 16))
    for x in (o, tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(x).all()
    _, lse = tfa.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), False,
        layout=torch.from_numpy(layout), block=16)
    assert torch.isneginf(lse[0, 0, 16:32]).all()
    assert torch.isfinite(lse[0, 0, :16]).all() and \
        torch.isfinite(lse[0, 1]).all()
    want = np.asarray(jsa.sparse_attention(*map(jnp.asarray, (q, k, v)),
                                           layout, 16))
    np.testing.assert_allclose(o.detach().numpy(), want, **FWD_TOL)
    assert np.abs(want[0, 0, 16:32]).max() == 0
    ref = sparse_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                     layout, 16)
    assert ref[0, 0, 16:32].abs().max() > 0.05      # the reference differs


def _brute_tiles(layout, block, s, tq, tk, causal):
    """live [H, nq, nk], full [H, nq, nk], diag [nq, nk] and the sub-block
    bits, from the element mask ``np.kron(layout, ones(block, block))``
    (causal: and tril) padded to whole tiles."""
    h = layout.shape[0]
    mask = np.kron(layout != 0, np.ones((block, block), bool))
    if causal:
        mask &= np.tril(np.ones((s, s), bool))[None]
    nq, nk = -(-s // tq), -(-s // tk)
    pad = np.zeros((h, nq * tq, nk * tk), bool)
    pad[:, :s, :s] = mask
    sub_q, sub_k = max(1, tq // block), max(1, tk // block)
    sub = pad.reshape(h, nq, sub_q, tq // sub_q, nk, sub_k, tk // sub_k)
    sub = sub.any(axis=(3, 6)).transpose(0, 1, 3, 2, 4)   # [h, nq, nk, q, k]
    weight = np.array([[1 << (8 * i + j) for j in range(sub_k)]
                       for i in range(sub_q)], dtype=object)
    bits = (sub.astype(object) * weight).sum(axis=(3, 4))
    tiles = pad.reshape(h, nq, tq, nk, tk)
    live = tiles.any(axis=(2, 4))
    inside = ((np.arange(nq) + 1) * tq <= s)[:, None] & \
        ((np.arange(nk) + 1) * tk <= s)[None]
    full = tiles.all(axis=(2, 4)) & inside[None]
    # some key of the tile after some query of it
    diag = np.zeros((nq, nk), bool)
    if causal:
        diag = (np.arange(nk) * tk + tk - 1)[None] > \
            (np.arange(nq) * tq)[:, None]
    return live, full, diag, bits


def _map_rows(tm):
    off, ent = tm.offsets.tolist(), tm.entries.tolist()
    masks = [m & (2 ** 64 - 1) for m in tm.masks.tolist()]
    # the launch order: every row once, by falling length, ties in row order
    lengths = [off[r + 1] - off[r] for r in range(len(off) - 1)]
    assert tm.order.tolist() == sorted(range(len(lengths)),
                                       key=lambda r: (-lengths[r], r))
    return [[(ent[e] & (tfa.DIAG - 1), bool(ent[e] & tfa.FULL),
              bool(ent[e] & tfa.DIAG), masks[e])
             for e in range(off[r], off[r + 1])]
            for r in range(len(off) - 1)]


@pytest.mark.parametrize("s,block", [(512, 16), (512, 32), (512, 64),
                                     (512, 128), (512, 256), (448, 16),
                                     (448, 64), (48, 16)])
def test_tile_maps_match_a_brute_force_over_the_mask(s, block):
    h, hkv = 4, 2
    layout = tsa.BigBirdSparsityConfig(num_heads=h, block=block,
                                       different_layout_per_head=True,
                                       num_random_blocks=1).make_layout(s)
    layout[1, 2 % (s // block)] = 0                 # an empty block row
    lay = torch.from_numpy(layout)
    for (tq, tk), causal in [(t, c) for t in ((128, 128), (128, 64),
                                              (64, 128), (64, 64))
                             for c in (False, True)]:
        live, full, diag, bits = _brute_tiles(layout, block, s, tq, tk,
                                              causal)
        nq, nk = live.shape[1:]
        want = [[(j, bool(full[hh, i, j]), bool(diag[i, j]),
                  int(bits[hh, i, j]))
                 for j in range(nk) if live[hh, i, j]]
                for hh in range(h) for i in range(nq)]
        tm = tfa.layout_tile_map(lay, block, s, tq, tk, causal)
        assert _map_rows(tm) == want, (tq, tk, causal)
        assert tm.live == int(live.sum())
        # dkv's column map: per (KV head, key tile), the (g, query tile)
        # pairs of query heads kvh * rep + g, g-major
        rep = h // hkv
        want = [[(g * nq + i, bool(full[kv * rep + g, i, j]), bool(diag[i, j]),
                  int(bits[kv * rep + g, i, j]))
                 for g in range(rep) for i in range(nq)
                 if live[kv * rep + g, i, j]]
                for kv in range(hkv) for j in range(nk)]
        tm = tfa.layout_tile_map(lay, block, s, tq, tk, causal, kv_heads=hkv)
        assert _map_rows(tm) == want, ("dkv", tq, tk, causal)


def test_kernel_tile_maps_are_cached_per_layout_and_version():
    layout = torch.from_numpy(tsa.FixedSparsityConfig(
        num_heads=2, block=16).make_layout(256))
    a = tfa._kernel_tile_map("fwd", torch.bfloat16, layout, 16, 256, True, 2,
                             2)
    assert tfa._kernel_tile_map("fwd", torch.bfloat16, layout, 16, 256, True,
                                2, 2) is a
    assert tfa._kernel_tile_map("dkv", torch.bfloat16, layout, 16, 256, True,
                                2, 1) is not a
    layout[0, 3] = 0                     # edited in place: mapped again
    b = tfa._kernel_tile_map("fwd", torch.bfloat16, layout, 16, 256, True, 2,
                             2)
    assert b is not a and b.live <= a.live
    with pytest.raises(ValueError, match="tile"):
        tfa.layout_tile_map(layout, 8, 256, 128, 128, False)


def test_entry_points_reuse_one_tile_map_across_calls(monkeypatch):
    """SparseSelfAttention and sparse_attention with an int32 device layout
    hand ``_SparseAttention`` the same layout tensor at every call, so the
    kernels' tile maps (cached by its identity) are built at the first call
    only.  The CUDA wrappers' map lookup is replayed on the CPU here."""
    seen = []
    apply = tfa._SparseAttention.apply

    def spy(q, k, v, layout, block, sm_scale, causal):
        seen.append((layout, tfa._kernel_tile_map(
            "fwd", torch.bfloat16, layout, block, q.shape[2], causal,
            q.shape[1], k.shape[1])))
        return apply(q, k, v, layout, block, sm_scale, causal)

    monkeypatch.setattr(tfa._SparseAttention, "apply", spy)
    monkeypatch.setattr(tfa, "_TILE_MAPS", type(tfa._TILE_MAPS)())
    cfg = tsa.BigBirdSparsityConfig(num_heads=2, block=16)
    attn = tsa.SparseSelfAttention(cfg)
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(4, 1, 2, 2, 64, 16))
    first = attn(q, k, v)
    torch.testing.assert_close(attn(q, k, v), first, atol=0, rtol=0)
    lay = torch.from_numpy(cfg.make_layout(64)[:1].astype(np.int32))
    tsa.sparse_attention(q, k, v, lay, 16)
    tsa.sparse_attention(q, k, v, lay, 16)
    (l0, m0), (l1, m1), (l2, m2), (l3, m3) = seen
    assert l0 is l1 and m0 is m1
    assert l2 is lay and l3 is lay and m2 is m3    # one-head: not expanded
    assert len(tfa._TILE_MAPS) == 2 and m0 is not m2


@pytest.mark.parametrize("causal", [True, False])
def test_tiled_models_with_a_layout_equal_the_plain_backward_in_float64(
        causal):
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)) for s in
                   ((2, 6, 192, 16), (2, 2, 192, 16), (2, 2, 192, 16),
                    (2, 6, 192, 16)))
    layout = tsa.BigBirdSparsityConfig(num_heads=6, block=16,
                                       different_layout_per_head=True
                                       ).make_layout(192)
    layout[:, 4] = 0
    kw = dict(layout=torch.from_numpy(layout), block=16)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal, **kw)
    delta = tfa._delta(o, do)
    dq = tfa.flash_attention_bwd_dq_tiled_plain(q, k, v, do, lse, delta,
                                                causal, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv_tiled_plain(q, k, v, do, lse, delta,
                                                     causal, **kw)
    want_dq, want_dk, want_dv = tfa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal, **kw)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def test_bf16_matches_the_jax_bf16_kernels():
    """bf16 inputs, GQA 4/2, a layout per head with an empty block row:
    the plain forward against JAX's bf16 ``_fwd`` with the layout, and the
    tiled backward models against JAX's bf16 ``_bwd_dq_call`` /
    ``_bwd_dkv_call`` with the layout given the same lse and delta, at the
    bars the CUDA kernels are held to (phase 2b's)."""
    b, h, hkv, s, d, block = 1, 4, 2, 64, 16, 16
    q, k, v, do = _qkv(21, b, h, hkv, s, d)
    layout = tsa.BigBirdSparsityConfig(num_heads=h, block=block,
                                       different_layout_per_head=True
                                       ).make_layout(s)
    layout[2, 1] = 0
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    kw = dict(layout=torch.from_numpy(layout), block=block)
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, False, **kw)
    rounded = [x.float().numpy() for x in (tq, tk, tv, tdo)]
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in rounded)
    want_o, want_lse = _jax_fwd(jq, jk, jv, layout, block, False)
    chip_smoke.flash_compare("o", o, torch.tensor(want_o), torch.bfloat16,
                             None)
    empty = torch.isneginf(lse)
    assert torch.equal(empty, torch.from_numpy(np.isneginf(want_lse)))
    np.testing.assert_allclose(lse[~empty].numpy(), want_lse[~empty.numpy()],
                               **FWD_TOL)
    delta = (torch.from_numpy(rounded[3]) * o.float()).sum(-1)
    dq = tfa.flash_attention_bwd_dq_tiled_plain(tq, tk, tv, tdo, lse, delta,
                                                False, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv_tiled_plain(tq, tk, tv, tdo, lse,
                                                     delta, False, **kw)
    lanes = lambda x: jnp.broadcast_to(  # noqa: E731
        jnp.asarray(x.numpy()).reshape(b * h, s)[..., None], (b * h, s, 128))
    flat = lambda x: x.reshape(-1, s, d)  # noqa: E731
    jkw = dict(sm_scale=1.0 / math.sqrt(d), causal=False, block_q=block,
               block_k=block, kv_len=s, interpret=True, head_rep=h // hkv,
               layout=jnp.asarray(layout, jnp.float32))
    args = (flat(jq), flat(jk), flat(jv), flat(jdo), lanes(lse), lanes(delta))
    want = (jfa._bwd_dq_call(*args, **jkw),) + jfa._bwd_dkv_call(*args, **jkw)
    for label, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32))).reshape(
            got.shape)
        chip_smoke.flash_compare(label, got, w, torch.bfloat16, None)
    assert torch.equal(dq[empty], torch.zeros_like(dq[empty]))


def test_sparse_self_attention_caches_layouts_and_refuses_masks():
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2,
                                  attention="unidirectional")
    attn = tsa.SparseSelfAttention(cfg)
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 2, 64, 16))
    out = attn(q, k, v)
    assert out.shape == q.shape and 64 in attn._layouts
    lay = attn._device_layout(64, q.device)
    attn(q, k, v)
    assert attn._device_layout(64, q.device) is lay       # one tensor, one map
    assert attn.get_layout(64) is attn._layouts[64]
    np.testing.assert_array_equal(attn.get_layout(64), cfg.make_layout(64))
    for kw in ({"rpe": q}, {"key_padding_mask": q}, {"attn_mask": q}):
        with pytest.raises(AssertionError, match="not supported"):
            attn(q, k, v, **kw)
    layout = cfg.make_layout(64)
    with pytest.raises(AssertionError, match="layout blocks"):
        tsa.sparse_attention(q[:, :, :48], k[:, :, :48], v[:, :, :48],
                             layout, 16)
    with pytest.raises(AssertionError):
        tsa.sparse_attention(q, k, v, np.ones((3, 4, 4)), 16)
    with pytest.raises(AssertionError, match="GQA"):
        tsa.sparse_attention(q, k[:, :1].repeat(1, 3, 1, 1),
                             v[:, :1].repeat(1, 3, 1, 1), layout, 16)
    # a one-head layout is broadcast to every head
    one = tsa.sparse_attention(q, k, v, layout[:1], 16, causal=True)
    torch.testing.assert_close(one, out, atol=0, rtol=0)


def test_wrappers_check_layouts_and_cpu_calls_never_count():
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(8, 1, 4, 2, 64, 16))
    lay = torch.from_numpy(tsa.BigBirdSparsityConfig(
        num_heads=4, block=16).make_layout(64))
    tfa.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd_cuda(q, k, v, False, layout=lay,
                                          block=16)
    dq, delta = tfa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                                causal=False, layout=lay,
                                                block=16)
    tfa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False,
                                     layout=lay, block=16)
    assert [(fn.launches, fn.layout_launches) for fn in tfa.KERNELS] == \
        [(0, 0)] * 3
    bad = [(lay.float(), 16, "integer or bool"), (lay, 24, "block"),
           (lay[:, :2, :2], 16, "layout"), (lay[:3], 16, "layout"),
           (np.asarray(lay), 16, "integer or bool")]
    for layout, block, match in bad:
        for call in (lambda: tfa.flash_attention_fwd_cuda(
                        q, k, v, layout=layout, block=block),
                     lambda: tfa.flash_attention_bwd_dkv_cuda(
                        q, k, v, do, lse, delta, layout=layout, block=block)):
            with pytest.raises(ValueError, match=match):
                call()
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.flash_attention_fwd_cuda(q, k[:, :, :32], v[:, :, :32],
                                     layout=lay, block=16)
