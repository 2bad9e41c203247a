"""The split-K arithmetic of the paged verify kernel
(``deepspeed_tpu_torch/ops/csrc/decode_attention.cu``,
``verify_split_kernel``) against the JAX package.

``paged_verify_split_plain`` models the kernel's algorithm in plain PyTorch:
each row's keys cut into fixed spans from key 0, a partial (max, sum,
unnormalised output) per span, then the log-sum-exp merge.  Here it is held
against the JAX package's ``paged_decode_attention_reference`` in float32 at
atol = rtol = 1e-5 (the two sum in different orders) over spans of 1 key, 8
keys and more than the table, block sizes 1, 4 and 16, windows of 2 and 16,
GQA rep 1 and 4, rows at base 0 and at the last base, and a -1 table entry
inside row 1's span.  The CUDA kernel itself is held against this model and
the reference on the card by ``chip_smoke.py``.
"""

import functools

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
KEYS = 48          # keys a row's table spans (NBPER * bs)


@functools.lru_cache(maxsize=None)
def _case(bs, t, rep, base0_only=False, d=16):
    """Inputs (numpy) and the JAX reference's output: 4 rows, 2 KV heads,
    head dim ``d``; positions 0, the last window base and two between (or
    all 0); shuffled tables with -1 past each row's span and one -1 inside
    row 1's span (both packages clamp it to scratch block 0)."""
    rng = np.random.default_rng(1000 * bs + 10 * t + rep)
    b, hkv = 4, 2
    nbper = KEYS // bs
    last = KEYS - t
    pos = np.zeros(b) if base0_only else np.concatenate(
        [[0, last], rng.integers(1, last, b - 2)])
    pos = pos.astype(np.int32)
    nb = 1 + b * nbper
    tables = rng.permutation(np.arange(1, nb)).reshape(b, nbper)
    for row in range(b):
        tables[row, (int(pos[row]) + t - 1) // bs + 1:] = -1
    tables[1, 0] = -1
    f = np.float32
    args = (rng.standard_normal((b, hkv * rep, t, d)).astype(f),
            rng.standard_normal((nb, hkv, bs, d)).astype(f),
            rng.standard_normal((nb, hkv, bs, d)).astype(f),
            tables.astype(np.int32), pos)
    want = np.asarray(jda.paged_decode_attention_reference(
        *map(jnp.asarray, args)))
    return args, want


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("keys_per_split", [1, 8, 4 * KEYS])
@pytest.mark.parametrize("bs", [1, 4, 16])
@pytest.mark.parametrize("t", [2, 16])
@pytest.mark.parametrize("rep", [1, 4])
def test_split_plain_matches_jax_reference(keys_per_split, bs, t, rep):
    args, want = _case(bs, t, rep)
    got = tda.paged_verify_split_plain(*map(_t, args),
                                       keys_per_split=keys_per_split)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("keys_per_split", [8, tda.VERIFY_KEYS_PER_SPLIT])
@pytest.mark.parametrize("t", [1, 5, 16])
def test_split_plain_at_head_dim_128(keys_per_split, t):
    """Llama's head dim 128 at GQA rep 4 (the D = 128 split kernels'
    model), against the JAX reference and the JAX Pallas verify / decode
    kernel in interpret mode."""
    args, want = _case(4, t, 4, d=128)
    got = tda.paged_verify_split_plain(*map(_t, args),
                                       keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    fn = jda.paged_decode_attention_pallas if t == 1 \
        else jda.paged_verify_attention_pallas
    pallas = np.asarray(fn(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("keys_per_split", [1, 8, tda.VERIFY_KEYS_PER_SPLIT])
def test_split_plain_rows_at_base_zero(keys_per_split):
    """Every row at base 0: every span but the first is empty (m = NEG_INF,
    l = 0) and must weigh nothing in the merge."""
    args, want = _case(4, 16, 1, base0_only=True)
    got = tda.paged_verify_split_plain(*map(_t, args),
                                       keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_split_plain_scalar_position_and_scale():
    """An int position (every row's window at one base) and an explicit
    sm_scale, as the reference takes them."""
    args, _ = _case(4, 16, 4)
    q, kp, vp, bt, _ = args
    want = np.asarray(jda.paged_decode_attention_reference(
        *map(jnp.asarray, (q, kp, vp, bt)), 5, sm_scale=0.3))
    got = tda.paged_verify_split_plain(*map(_t, (q, kp, vp, bt)), 5,
                                       sm_scale=0.3, keys_per_split=8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_split_plain_in_bf16_follows_the_reference():
    """bf16 inputs: the model computes in float32 and rounds once, so it
    stays within one bf16 ulp of the port's reference (which rounds the
    probabilities to bf16 before its product)."""
    args, _ = _case(16, 16, 1)
    q, kp, vp, bt, pos = (_t(x) for x in args)
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    got = tda.paged_verify_split_plain(q, kp, vp, bt, pos, keys_per_split=8)
    want = tda.paged_decode_attention_reference(q, kp, vp, bt, pos)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("nbper,bs,want", [
    (32, 32, 8), (33, 32, 9), (1, 1, 1), (128, 1, 1), (129, 1, 2),
    (5, 16, 1), (9, 16, 2), (64, 16, 8)])
def test_verify_splits_from_the_table_width(nbper, bs, want):
    assert tda.verify_splits(nbper, bs) == want
    assert tda.verify_splits(nbper, bs) * tda.VERIFY_KEYS_PER_SPLIT \
        >= nbper * bs


def test_verify_splits_other_span():
    assert tda.verify_splits(6, 8, keys_per_split=1) == 48
    assert tda.verify_splits(6, 8, keys_per_split=8) == 6
    assert tda.verify_splits(6, 8, keys_per_split=1000) == 1


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "split"), (torch.float16, "split"),
    (torch.float32, "template")])
def test_verify_route_by_dtype(dtype, route):
    assert tda.verify_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8])
def test_verify_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError):
        tda.verify_route(dtype)


def test_cpu_verify_wrapper_takes_the_plain_path_uncounted():
    """On the CPU the verify wrapper computes the reference, whatever the
    dtype, and counts no launch."""
    tda.reset_launch_counts()
    args, want = _case(4, 16, 4)
    got = tda.paged_verify_attention_cuda(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tda.paged_verify_attention_cuda.launches == 0
