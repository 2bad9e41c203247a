"""The PyTorch port's decode attention (``deepspeed_tpu_torch/ops/
decode_attention.py``) against the JAX package's plain references.

On the CPU the port's kernel wrappers take their plain versions, so every
case here holds the port's arithmetic against JAX's in fp32 (atol = rtol =
1e-5: the two frameworks sum in different orders).  The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py`` (the machine with the card has no JAX, so these tests
cannot run there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import decode_attention as jda
from deepspeed_tpu_torch.ops import decode_attention as tda

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, b, h, hkv, t, d=16, bs=8, nbper=6, per_row=True):
    """Ragged positions (incl. 0 and the last valid base); tables hold a
    shuffled block set with -1 past each row's span and one -1 inside
    row 1's span (clamped to scratch block 0 by both packages)."""
    rng = np.random.default_rng(seed)
    s = bs * nbper
    last = s - t
    pos = np.concatenate([[0, last], rng.integers(1, last, b - 2)])
    pos = pos.astype(np.int32) if per_row else np.int32(rng.integers(0, last))
    nb = 1 + b * nbper
    tables = rng.permutation(np.arange(1, nb)).reshape(b, nbper)
    for row, p in enumerate(np.broadcast_to(pos, (b,))):
        tables[row, (int(p) + t - 1) // bs + 1:] = -1
    tables[1, 0] = -1
    f = np.float32
    return dict(
        q=rng.standard_normal((b, h, t, d)).astype(f),
        k=rng.standard_normal((b, hkv, s, d)).astype(f),
        v=rng.standard_normal((b, hkv, s, d)).astype(f),
        kp=rng.standard_normal((nb, hkv, bs, d)).astype(f),
        vp=rng.standard_normal((nb, hkv, bs, d)).astype(f),
        bt=tables.astype(np.int32), pos=pos)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("t", [1, 2, 16])
@pytest.mark.parametrize("per_row", [True, False])
def test_decode_attention_reference_matches_jax(rep, t, per_row):
    c = _case(rep * 100 + t, b=4, h=2 * rep, hkv=2, t=t, per_row=per_row)
    want = jda.decode_attention_reference(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["pos"]))
    got = tda.decode_attention_reference(_t(c["q"]), _t(c["k"]), _t(c["v"]),
                                         _t(c["pos"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the dispatcher (single-token wrapper on the CPU = plain path) agrees
    got = tda.decode_attention(_t(c["q"]), _t(c["k"]), _t(c["v"]),
                               _t(c["pos"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("t", [1, 2, 16])
def test_paged_attention_reference_matches_jax(rep, t):
    c = _case(rep * 10 + t, b=4, h=2 * rep, hkv=2, t=t)
    args = (c["q"], c["kp"], c["vp"], c["bt"], c["pos"])
    want = np.asarray(jda.paged_decode_attention_reference(
        *map(jnp.asarray, args)))
    got = tda.paged_decode_attention_reference(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dispatcher routes T == 1 to the decode wrapper and 2..16 to the
    # verify wrapper — on the CPU both take the plain path
    got = tda.paged_decode_attention(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t", [1, 5, 16])
def test_head_dim_128_gqa_matches_jax_reference_and_pallas(t):
    """Llama's geometry: head dim 128, GQA rep 4 (8 query heads over 2 KV
    heads), ragged rows: the plain paths and the split-K model against
    the JAX reference and its Pallas kernels in interpret mode (the
    contiguous decode at T = 1, the paged decode or verify)."""
    c = _case(900 + t, b=4, h=8, hkv=2, t=t, d=128, bs=16, nbper=10)
    args = (c["q"], c["kp"], c["vp"], c["bt"], c["pos"])
    jargs = tuple(map(jnp.asarray, args))
    want = np.asarray(jda.paged_decode_attention_reference(*jargs))
    fn = jda.paged_decode_attention_pallas if t == 1 \
        else jda.paged_verify_attention_pallas
    np.testing.assert_allclose(np.asarray(fn(*jargs, interpret=True)), want,
                               **TOL)
    for got in (tda.paged_decode_attention(*map(_t, args)),
                tda.paged_verify_split_plain(*map(_t, args))):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    if t != 1:
        return
    cargs = (c["q"], c["k"], c["v"], c["pos"])
    want = np.asarray(jda.decode_attention_reference(*map(jnp.asarray,
                                                         cargs)))
    np.testing.assert_allclose(np.asarray(jda.decode_attention_pallas(
        *map(jnp.asarray, cargs), interpret=True)), want, **TOL)
    bt = torch.arange(4, dtype=torch.int32)[:, None]
    for got in (tda.decode_attention(*map(_t, cargs)),
                tda.paged_verify_split_plain(_t(c["q"]), _t(c["k"]),
                                             _t(c["v"]), bt, _t(c["pos"]))):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("paged", [True, False])
def test_sliced_window_attention_matches_jax_reference(paged):
    """A 40-position window through ``sliced_window_attention`` (slices of
    16, 16 and 8 at their own bases; on the CPU each slice takes the plain
    version) against the JAX reference of the whole window, head dim 128,
    GQA rep 4, per-row and shared positions."""
    c = _case(950, b=3, h=8, hkv=2, t=40, d=128, bs=16, nbper=6)
    if paged:
        args = (c["q"], c["kp"], c["vp"], c["bt"], c["pos"])
        want = jda.paged_decode_attention_reference(*map(jnp.asarray, args))
        got = tda.sliced_window_attention(_t(c["q"]), _t(c["kp"]),
                                          _t(c["vp"]), _t(c["pos"]),
                                          _t(c["bt"]))
    else:
        args = (c["q"], c["k"], c["v"], np.int32(17))
        want = jda.decode_attention_reference(*map(jnp.asarray, args))
        got = tda.sliced_window_attention(_t(c["q"]), _t(c["k"]),
                                          _t(c["v"]), 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert [fn.launches for fn in tda.KERNELS] == [0] * 5


def test_wide_window_takes_the_plain_path_and_cpu_never_counts():
    """Windows past VERIFY_T_MAX go to the plain path, and CPU calls never
    count as kernel launches."""
    tda.reset_launch_counts()
    t = tda.VERIFY_T_MAX + 4
    c = _case(7, b=3, h=4, hkv=2, t=t)
    args = (c["q"], c["kp"], c["vp"], c["bt"], c["pos"])
    want = np.asarray(jda.paged_decode_attention_reference(
        *map(jnp.asarray, args)))
    got = tda.paged_decode_attention(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    tda.paged_decode_attention(*map(_t, (c["q"][:, :, :1],) + args[1:]))
    tda.decode_attention(_t(c["q"][:, :, :1]), _t(c["k"]), _t(c["v"]), 5)
    assert [fn.launches for fn in tda.KERNELS] == [0] * 5
    assert tda.VERIFY_T_MAX == jda.VERIFY_T_MAX
    assert tda.NEG_INF == jda.NEG_INF


def test_row_pos_takes_an_int_or_a_row_tensor():
    """The wrappers' positions: an int (``generate`` decodes every row at one
    position) broadcasts to int32 [B]; a 0-d or [B] tensor is cast; a tensor
    of another size or on another device than the queries raises."""
    cpu = torch.device("cpu")
    for q_pos in (160, torch.tensor(160), torch.tensor([160] * 4)):
        got = tda._row_pos(q_pos, 4, cpu)
        assert got.dtype == torch.int32 and got.tolist() == [160] * 4
        assert got.is_contiguous()
    got = tda._row_pos(torch.tensor([0, 7, 1023, 5], dtype=torch.int64), 4,
                       cpu)
    assert got.dtype == torch.int32 and got.tolist() == [0, 7, 1023, 5]
    with pytest.raises(ValueError):
        tda._row_pos(torch.tensor([1, 2]), 4, cpu)
    with pytest.raises(ValueError):
        tda._row_pos(torch.tensor([1, 2, 3, 4], device="meta"), 4, cpu)
