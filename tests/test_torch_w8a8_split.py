"""The tiling of the w8a8 kernel (``deepspeed_tpu_torch/ops/csrc/
quantized_matmul.cu``, ``w8a8_split_kernel``) and the float-pool paged
decode's route onto the split-K attention kernel, against the JAX package.

``w8a8_matmul_split_plain`` models the w8a8 kernel: one term t_g per
(64-column tile, k-group), the pairs taken in any order as the kernel's
blocks run, then the terms summed in group order.  It must give the bits
of ``w8a8_matmul_plain`` (the kernel is held to those bits on the card by
``chip_smoke.py``), and agree with the JAX package's ``_w8a8_call`` /
``_w8a8_stacked_call`` run in interpret mode, as
``test_torch_quantized_matmul.py`` runs them: fp32 at rtol 1e-5, bf16 at
2e-2.  Cases: K = 128, 384 and 768, k-groups of 128 and 256 (and 96), N =
128 and 896, every row count from 1 to 8, a zero k-group, B6's layer index
L (clamped, in both packages) and -1 (clamped to 0 by the port's kernel;
JAX's interpret mode wraps it to L - 1, so that index is held against the
port's plain version only).

The 16-bit float single-token decode now runs the split-K kernel with a
window of one (``decode_route``), on a paged pool and on a contiguous cache
read as a pool of one block per row: ``paged_verify_split_plain`` at T = 1
is held against the JAX package's ``paged_decode_attention_reference`` /
``decode_attention_reference`` and its Pallas decode kernels in interpret
mode at 1e-5 in fp32, over block sizes 1, 4 and 16, caches of 40, 100 and
300 keys, GQA rep 1 and 4, rows at base 0 and a -1 table entry.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import decode_attention as jda
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu.ops import quantized_matmul as jqm
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import quantization as tq
from deepspeed_tpu_torch.ops import quantized_matmul as tqm

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)

# (K, k-group, N): one group, an odd number of groups, GPT-2's K, the
# default k-group of quantize_k_grouped, and a group that is no multiple of
# the tensor cores' 32-deep step
SHAPES = [(128, 128, 128), (384, 128, 896), (768, 128, 128),
          (768, 256, 896), (768, 128, 896), (384, 96, 128)]


@functools.lru_cache(maxsize=None)
def _recs(k, k_group, n, layers=3):
    """8 activation rows (numpy, float32) whose row 2 has a zero last
    k-group (its ax reads as 1), and the port's and the JAX package's
    k-grouped records of the same [L, K, N] weights."""
    rng = np.random.default_rng(k + 7 * n + k_group)
    w = (rng.standard_normal((layers, k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((8, k)).astype(np.float32)
    x[2, k - k_group:] = 0.0
    return (x, tq.quantize_k_grouped(torch.from_numpy(w), k_group),
            jq.quantize_k_grouped(jnp.asarray(w), k_group))


def _jax_w8a8(x, jrec, layer, dtype, stacked):
    """The JAX Pallas kernel in interpret mode on layer ``layer``."""
    k, n = jrec["qk"].shape[-2:]
    bk, _ = jqm._w8a8_pick_bk(k, jrec["kscale"].shape[-3], n, None)
    assert bk > 0
    xj = jnp.asarray(x, dtype)
    if stacked:
        return jqm._w8a8_stacked_call(jnp.int32(layer), xj, jrec["qk"],
                                      jrec["kscale"], jnp.float32, bk, True)
    return jqm._w8a8_call(xj, jrec["qk"][layer], jrec["kscale"][layer],
                          jnp.float32, bk, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,k_group,n", SHAPES)
def test_split_plain_equals_plain_bit_for_bit(k, k_group, n, dtype):
    """Every row count 1-8, the pairs in the default order (last to first)
    and in a shuffled one: the bits of ``w8a8_matmul_plain``."""
    x, trec, _ = _recs(k, k_group, n)
    qk, ks = trec["qk"][1], trec["kscale"][1]
    pairs = (n // tqm.W8A8_TILE_N) * (k // k_group)
    shuffled = np.random.default_rng(k + n).permutation(pairs)
    for rows in range(1, 9):
        xt = torch.from_numpy(x[:rows]).to(dtype)
        want = tqm.w8a8_matmul_plain(xt, qk, ks)
        for order in (None, shuffled):
            got = tqm.w8a8_matmul_split_plain(xt, qk, ks, order=order)
            assert got.dtype == dtype and torch.equal(got, want)
        f32 = tqm.w8a8_matmul_split_plain(xt, qk, ks, torch.float32)
        assert torch.equal(f32, tqm.w8a8_matmul_plain(xt, qk, ks,
                                                      torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,k_group,n", SHAPES)
def test_split_plain_matches_jax_w8a8_call(k, k_group, n, dtype):
    x, trec, jrec = _recs(k, k_group, n)
    for rows in (1, 4, 8):
        want = np.asarray(_jax_w8a8(x[:rows], jrec, 1, dtype, False))
        xt = torch.from_numpy(x[:rows]).to(getattr(torch, dtype))
        got = tqm.w8a8_matmul_split_plain(xt, trec["qk"][1],
                                          trec["kscale"][1], torch.float32)
        np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [112, 224])
def test_split_plain_equals_jax_past_104_groups(groups, dtype):
    """The long-K shapes (llama-3-8b's w2 at 112 k-groups of 128, and
    llama-3-70b's at 224), which a block's shared memory no longer bounds:
    the split model in its cluster's block layout (7 and 14 groups a
    block) equals the plain version bit for bit, and the JAX
    ``_w8a8_call`` and ``_w8a8_stacked_call`` in interpret mode at the
    file's tolerances, f32 out.  (XLA on the CPU sums the groups' terms
    with other roundings than the kernel's literal order: at two or more
    groups the JAX interpret kernel differs from that order in the last
    bits of 44-77% of the outputs, so no port can equal it bit for bit and
    keep GPT-2's bits.)"""
    k = 128 * groups
    x, trec, jrec = _recs(k, 128, 128, layers=2)
    gpb = tqm.w8a8_groups_per_block(groups)
    assert gpb == groups // 16
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qk, ks = trec["qk"][1], trec["kscale"][1]
    # the (tile, group) pairs in an order the kernel's blocks may take:
    # block y's groups together, the last block first, tile by tile
    order = [tile * groups + g for tile in (1, 0)
             for y in reversed(range(16)) for g in range(y * gpb,
                                                         (y + 1) * gpb)]
    got = tqm.w8a8_matmul_split_plain(xt, qk, ks, torch.float32, order=order)
    assert torch.equal(got, tqm.w8a8_matmul_plain(xt, qk, ks, torch.float32))
    for stacked in (False, True):
        want = np.asarray(_jax_w8a8(x, jrec, 1, dtype, stacked))
        np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,k_group,n", [(384, 128, 896), (768, 256, 128)])
def test_split_plain_matches_jax_stacked_call(k, k_group, n, dtype):
    """B6: layer indices 0, L - 1 and L (clamped to L - 1 in both
    packages) against ``_w8a8_stacked_call``; the port's CPU wrapper takes
    the same layer."""
    x, trec, jrec = _recs(k, k_group, n)
    n_layers = trec["qk"].shape[0]
    xt = torch.from_numpy(x[:4]).to(getattr(torch, dtype))
    for idx in (0, n_layers - 1, n_layers):
        l = min(idx, n_layers - 1)
        want = np.asarray(_jax_w8a8(x[:4], jrec, idx, dtype, True))
        got = tqm.w8a8_matmul_split_plain(xt, trec["qk"][l],
                                          trec["kscale"][l], torch.float32)
        np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
        wrapped = tqm.w8a8_matmul_stacked_cuda(
            torch.tensor([idx], dtype=torch.int32), xt, trec["qk"],
            trec["kscale"], torch.float32)
        assert torch.equal(wrapped, got)


def test_stacked_index_minus_one_clamps_to_layer_zero():
    """The kernel reads the index on the card and clamps it to [0, L); on
    the CPU the wrapper takes the same layer."""
    x, trec, _ = _recs(384, 128, 896)
    xt = torch.from_numpy(x[:3])
    got = tqm.w8a8_matmul_stacked_cuda(torch.tensor([-1], dtype=torch.int32),
                                       xt, trec["qk"], trec["kscale"])
    want = tqm.w8a8_matmul_split_plain(xt, trec["qk"][0], trec["kscale"][0])
    assert torch.equal(got, want)
    assert not torch.equal(got, tqm.w8a8_matmul_plain(
        xt, trec["qk"][2], trec["kscale"][2]))


def test_zero_k_group_reads_ax_as_one():
    """Row 2's zero k-group contributes exact zeros: the row equals the
    same row with that group's weights zeroed."""
    x, trec, _ = _recs(384, 128, 896)
    qk, ks = trec["qk"][0], trec["kscale"][0]
    xt = torch.from_numpy(x[2:3])
    got = tqm.w8a8_matmul_split_plain(xt, qk, ks, torch.float32)
    qz = qk.clone()
    qz[-128:] = 0
    assert torch.isfinite(got).all()
    assert torch.equal(got, tqm.w8a8_matmul_plain(xt, qz, ks, torch.float32))


@pytest.mark.parametrize("groups,gpb", [
    (1, 1), (3, 1), (6, 1), (16, 1), (17, 17), (24, 2), (40, 4), (41, 41),
    (104, 8), (105, 7), (107, 0), (112, 7), (224, 14), (1664, 104),
    (1665, 0)])
def test_w8a8_groups_per_block(groups, gpb):
    """The launcher's rule: the fewest k-groups a block that divide K / G
    and leave at most 16 blocks (one cluster) a column tile; none when that
    is more than 104 groups a block, whose terms would not fit its shared
    memory (a prime count past 104, or past 16 x 104 groups)."""
    assert tqm.w8a8_groups_per_block(groups) == gpb
    if gpb:
        assert groups % gpb == 0 and groups // gpb <= 16


def test_cpu_w8a8_wrappers_take_the_plain_path_uncounted():
    tqm.reset_launch_counts()
    x, trec, _ = _recs(768, 256, 896)
    xt = torch.from_numpy(x[:5]).to(torch.bfloat16)
    qk, ks = trec["qk"][2], trec["kscale"][2]
    want = tqm.w8a8_matmul_split_plain(xt, qk, ks)
    assert torch.equal(tqm.w8a8_matmul_cuda(xt, qk, ks), want)
    for idx in (2, 3):
        assert torch.equal(tqm.w8a8_matmul_stacked_cuda(
            torch.tensor([idx], dtype=torch.int32), xt, trec["qk"],
            trec["kscale"]), want)
    assert tqm.w8a8_matmul_cuda.launches == 0
    assert tqm.w8a8_matmul_stacked_cuda.launches == 0


# ---------------------------------------------------------------------------
# float B3 on the split-K kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _decode_case(bs, rep, base0_only=False):
    """T = 1 inputs (numpy) on a float32 pool and both JAX outputs (the
    reference and the Pallas decode kernel in interpret mode): 4 rows, 2 KV
    heads, head dim 16, 48-key tables; positions 0, the last and two
    between (or all 0); shuffled tables with -1 past each row's span and
    one -1 inside row 1's span (both packages clamp it to scratch block
    0)."""
    rng = np.random.default_rng(100 * bs + rep + 7 * base0_only)
    b, hkv, d, keys = 4, 2, 16, 48
    nbper = keys // bs
    pos = np.zeros(b) if base0_only else np.concatenate(
        [[0, keys - 1], rng.integers(1, keys - 1, b - 2)])
    pos = pos.astype(np.int32)
    nb = 1 + b * nbper
    tables = rng.permutation(np.arange(1, nb)).reshape(b, nbper)
    for row in range(b):
        tables[row, int(pos[row]) // bs + 1:] = -1
    tables[1, 0] = -1
    f = np.float32
    args = (rng.standard_normal((b, hkv * rep, 1, d)).astype(f),
            rng.standard_normal((nb, hkv, bs, d)).astype(f),
            rng.standard_normal((nb, hkv, bs, d)).astype(f),
            tables.astype(np.int32), pos)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jda.paged_decode_attention_reference(*jargs))
    pallas = np.asarray(jda.paged_decode_attention_pallas(*jargs,
                                                          interpret=True))
    return args, ref, pallas


@pytest.mark.parametrize("keys_per_split", [8, tda.VERIFY_KEYS_PER_SPLIT])
@pytest.mark.parametrize("base0_only", [False, True])
@pytest.mark.parametrize("bs", [1, 4, 16])
@pytest.mark.parametrize("rep", [1, 4])
def test_decode_split_plain_matches_jax(keys_per_split, base0_only, bs, rep):
    args, ref, pallas = _decode_case(bs, rep, base0_only)
    got = tda.paged_verify_split_plain(*map(torch.from_numpy, args),
                                       keys_per_split=keys_per_split)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **ATTN_TOL)


@functools.lru_cache(maxsize=None)
def _contiguous_case(s, rep):
    """T = 1 on a contiguous float32 cache [4, 2, S, 16] at positions 0,
    S - 1 and two between, with both JAX outputs (the reference and the
    Pallas decode kernel in interpret mode)."""
    rng = np.random.default_rng(10 * s + rep)
    b, hkv, d = 4, 2, 16
    pos = np.concatenate([[0, s - 1], rng.integers(1, s - 1, b - 2)])
    f = np.float32
    args = (rng.standard_normal((b, hkv * rep, 1, d)).astype(f),
            rng.standard_normal((b, hkv, s, d)).astype(f),
            rng.standard_normal((b, hkv, s, d)).astype(f),
            pos.astype(np.int32))
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jda.decode_attention_reference(*jargs))
    pallas = np.asarray(jda.decode_attention_pallas(*jargs, interpret=True))
    return args, ref, pallas


@pytest.mark.parametrize("keys_per_split", [8, tda.VERIFY_KEYS_PER_SPLIT])
@pytest.mark.parametrize("s", [40, 100, 300])
@pytest.mark.parametrize("rep", [1, 4])
def test_contiguous_decode_as_pool_matches_jax(keys_per_split, s, rep):
    """B2's 16-bit route reads the cache [B, HKV, S, D] as a pool of B
    blocks of S keys with the tables [[0], [1], ...]: the split model on
    that view against ``decode_attention_reference`` and
    ``decode_attention_pallas`` (interpret mode) at 1e-5 in fp32."""
    args, ref, pallas = _contiguous_case(s, rep)
    q, k, v, pos = map(torch.from_numpy, args)
    tables = torch.arange(4, dtype=torch.int32)[:, None]
    got = tda.paged_verify_split_plain(q, k, v, tables, pos,
                                       keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **ATTN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_contiguous_decode_wrapper_takes_the_plain_path_uncounted(dtype):
    tda.reset_launch_counts()
    args, ref, _ = _contiguous_case(100, 4)
    q, k, v, pos = map(torch.from_numpy, args)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = tda.decode_attention_cuda(q, k, v, pos)
    assert torch.equal(got, tda.decode_attention_reference(q, k, v, pos))
    assert tda.decode_attention_cuda.launches == 0


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "split"), (torch.float16, "split"),
    (torch.float32, "template")])
def test_decode_route_by_dtype(dtype, route):
    assert tda.decode_route(dtype) == route
    assert tda.decode_route(dtype) == tda.verify_route(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8])
def test_decode_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError):
        tda.decode_route(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_decode_wrapper_takes_the_plain_path_uncounted(dtype):
    """On the CPU the paged decode wrapper computes the reference, whatever
    the dtype's route on the card, and counts no launch."""
    tda.reset_launch_counts()
    args, ref, _ = _decode_case(4, 4)
    q, kp, vp, bt, pos = map(torch.from_numpy, args)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    got = tda.paged_decode_attention_cuda(q, kp, vp, bt, pos)
    assert torch.equal(got, tda.paged_decode_attention_reference(
        q, kp, vp, bt, pos))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)
    assert tda.paged_decode_attention_cuda.launches == 0
