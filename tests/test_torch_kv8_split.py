"""The split-K arithmetic of the int8-pool paged attention kernel
(``deepspeed_tpu_torch/ops/csrc/decode_attention.cu``, ``q8_split_kernel``)
against the JAX package's Pallas kernels on the same int8 records.

``paged_verify_split_plain`` models the kernel on an int8 pool record:
codes in place of K and V, each key's K scale on its score column, its V
scale on its probability before the product with V's codes, the running
max and sum over the unscaled probabilities, per-split partials and the
log-sum-exp merge.  Here it is held against ``paged_decode_attention_pallas``
(T = 1) and ``paged_verify_attention_pallas`` (T > 1), run in interpret mode
as the JAX package's own tests run them on the CPU, in float32 at atol =
rtol = 1e-5 and with bf16 queries at 2e-2 (one bf16 ulp of the output), as
``test_kv8_paged_attention_matches_jax``.  Cases: windows of 1, 2 and 16,
GQA rep 1 and 4, block sizes 1, 4 and 16, spans of 1, 8 and 128 keys, a -1
table entry inside row 1's span, every row at base 0, and tables of 48 and
44 keys (no whole number of 8- or 128-key spans).  The CUDA kernel itself
is held against this model and the plain version on the card by
``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import decode_attention as jda
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu_torch.ops import decode_attention as tda

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@functools.lru_cache(maxsize=None)
def _case(bs, t, rep, keys=48, base0_only=False, dtype="float32", d=16):
    """int8 records (numpy: codes, and bf16 scales as float32), queries,
    tables and positions, and the JAX Pallas kernel's output: 4 rows, 2 KV
    heads, head dim ``d``; positions 0, the last window base and two
    between (or all 0); shuffled tables with -1 past each row's span and
    one -1 inside row 1's span (both packages clamp it to scratch block
    0)."""
    rng = np.random.default_rng(1000 * bs + 10 * t + rep + keys)
    b, hkv = 4, 2
    nbper = keys // bs
    last = keys - t
    pos = np.zeros(b) if base0_only else np.concatenate(
        [[0, last], rng.integers(1, last, b - 2)])
    pos = pos.astype(np.int32)
    nb = 1 + b * nbper
    tables = rng.permutation(np.arange(1, nb)).reshape(b, nbper)
    for row in range(b):
        tables[row, (int(pos[row]) + t - 1) // bs + 1:] = -1
    tables[1, 0] = -1
    tables = tables.astype(np.int32)
    pools = []
    for _ in range(2):
        codes, scale = jq.quantize_kv(jnp.asarray(
            rng.standard_normal((nb, hkv, bs, d)), jnp.float32))
        pools.append((np.asarray(codes),
                      np.asarray(scale.astype(jnp.float32))))
    q = rng.standard_normal((b, hkv * rep, t, d)).astype(np.float32)
    jpools = [{"qp": jnp.asarray(c), "ps": jnp.asarray(s, jnp.bfloat16)}
              for c, s in pools]
    fn = jda.paged_decode_attention_pallas if t == 1 \
        else jda.paged_verify_attention_pallas
    want = fn(jnp.asarray(q, dtype), *jpools, jnp.asarray(tables),
              jnp.asarray(pos), interpret=True)
    return q, pools, tables, pos, np.asarray(want.astype(jnp.float32))


def _torch_args(case, dtype=torch.float32):
    q, pools, tables, pos, _ = case
    recs = [{"qp": torch.tensor(c), "ps": torch.tensor(s).to(torch.bfloat16)}
            for c, s in pools]
    return (torch.tensor(q).to(dtype), *recs, torch.tensor(tables),
            torch.tensor(pos))


@pytest.mark.parametrize("keys_per_split", [1, 8, tda.VERIFY_KEYS_PER_SPLIT])
@pytest.mark.parametrize("bs", [1, 4, 16])
@pytest.mark.parametrize("t", [1, 2, 16])
@pytest.mark.parametrize("rep", [1, 4])
def test_kv8_split_plain_matches_jax_pallas(keys_per_split, bs, t, rep):
    case = _case(bs, t, rep)
    got = tda.paged_verify_split_plain(*_torch_args(case),
                                       keys_per_split=keys_per_split)
    assert got.dtype == torch.float32 and got.shape == case[-1].shape
    np.testing.assert_allclose(got.numpy(), case[-1], **TOL)


@pytest.mark.parametrize("keys_per_split", [8, tda.VERIFY_KEYS_PER_SPLIT])
@pytest.mark.parametrize("t", [1, 5, 16])
def test_kv8_split_plain_at_head_dim_128(keys_per_split, t):
    """Llama's head dim 128 at GQA rep 4 on int8 records (the D = 128
    ``q8_split_kernel``'s model) against the JAX Pallas kernel in
    interpret mode; bf16 queries against its bf16 run."""
    case = _case(4, t, 4, d=128)
    got = tda.paged_verify_split_plain(*_torch_args(case),
                                       keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.numpy(), case[-1], **TOL)
    bf = _case(4, t, 4, d=128, dtype="bfloat16")
    got = tda.paged_verify_split_plain(*_torch_args(bf, torch.bfloat16),
                                       keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.float().numpy(), bf[-1], **BF16_TOL)


@pytest.mark.parametrize("keys_per_split", [1, 8, tda.VERIFY_KEYS_PER_SPLIT])
@pytest.mark.parametrize("t", [1, 16])
def test_kv8_split_plain_rows_at_base_zero(keys_per_split, t):
    """Every row at base 0: every span but the first is empty (m = NEG_INF,
    l = 0) and must weigh nothing in the merge."""
    case = _case(4, t, 1, base0_only=True)
    got = tda.paged_verify_split_plain(*_torch_args(case),
                                       keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.numpy(), case[-1], **TOL)


@pytest.mark.parametrize("keys_per_split", [8, tda.VERIFY_KEYS_PER_SPLIT])
@pytest.mark.parametrize("t", [1, 2, 16])
def test_kv8_split_plain_table_not_whole_splits(keys_per_split, t):
    """A 44-key table (11 blocks of 4): the last span is cut short."""
    case = _case(4, t, 4, keys=44)
    assert 44 % keys_per_split
    got = tda.paged_verify_split_plain(*_torch_args(case),
                                       keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.numpy(), case[-1], **TOL)


@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("rep", [1, 4])
def test_kv8_split_plain_bf16_queries(t, rep):
    """bf16 queries: the model computes in float32 from the bf16 queries and
    rounds once, as the JAX kernel does."""
    case = _case(16, t, rep, dtype="bfloat16")
    got = tda.paged_verify_split_plain(*_torch_args(case, torch.bfloat16),
                                       keys_per_split=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), case[-1], **BF16_TOL)


def test_kv8_split_plain_scalar_position_and_scale():
    """An int position (every row's window at one base) and an explicit
    sm_scale, as the JAX kernels take them."""
    case = _case(4, 16, 4)
    q, pools, tables = case[:3]
    jpools = [{"qp": jnp.asarray(c), "ps": jnp.asarray(s, jnp.bfloat16)}
              for c, s in pools]
    want = jda.paged_verify_attention_pallas(
        jnp.asarray(q), *jpools, jnp.asarray(tables), 5, sm_scale=0.3,
        interpret=True)
    args = _torch_args(case)[:-1]
    got = tda.paged_verify_split_plain(*args, 5, sm_scale=0.3,
                                       keys_per_split=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kv8_split_plain_follows_the_dequantizing_reference():
    """The model (scales folded into columns) and the port's plain version
    (which dequantizes first) compute one function."""
    case = _case(4, 16, 4)
    args = _torch_args(case)
    got = tda.paged_verify_split_plain(*args, keys_per_split=8)
    want = tda.paged_decode_attention_reference(*args)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "split"), (torch.float16, "split"),
    (torch.float32, "template")])
def test_kv8_route_by_dtype(dtype, route):
    assert tda.kv8_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8, torch.int32])
def test_kv8_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError):
        tda.kv8_route(dtype)


@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_kv8_wrappers_take_the_plain_path_uncounted(t, dtype):
    """On the CPU the kv8 wrappers compute the plain version, whatever the
    route their dtype would take on the card, and count no launch."""
    tda.reset_launch_counts()
    args = _torch_args(_case(4, t, 4), dtype)
    fn = tda.paged_decode_attention_kv8_cuda if t == 1 \
        else tda.paged_verify_attention_kv8_cuda
    got = fn(*args)
    want = tda.paged_decode_attention_reference(*args)
    assert torch.equal(got, want)
    assert got.dtype == dtype
    assert [f.launches for f in tda.KERNELS] == [0] * len(tda.KERNELS)
