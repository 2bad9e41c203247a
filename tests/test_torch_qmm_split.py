"""The tiling of the weight-only int8 kernel (``deepspeed_tpu_torch/ops/
csrc/quantized_matmul.cu``, ``qmm_split_kernel``) against the JAX package.

``quantized_matmul_split_plain`` models the kernel's sum order: K cut into
spans of ``qmm_chunks_per_block`` 128-row chunks, one f32 term per (block,
64-column tile), the terms summed in block order in f32.  It must agree
with ``quantized_matmul_plain`` (exact bf16 products summed in float64) at
1e-5 in fp32, and with the JAX package's ``quantized_matmul`` under
``DS_QMM=1``, which runs ``_qmm_call`` in interpret mode as
``test_torch_quantized_matmul.py`` runs it: fp32 at rtol 1e-5, bf16 at 2e-2
(one bf16 ulp of the output).  Cases: K = 128 (one chunk), 200 (a tail
chunk of 72 rows), 384, 512, 768 and 3072 (two chunks a block, held
against JAX at N = 128 only); N = 128 and 896 with G = 128 and G = N, and
N = 512 with G = 256 (no N of 128 or 896 holds whole groups of 256); 1, 4,
8, 9, 33 and 256 rows against the plain versions, 1, 9 and 256 against
JAX (each row count compiles the JAX kernel anew).  A row's
result is the same bits in a call of any row count, because the launcher's
chunk rule reads (K, N, G) and no row count: the rule is mirrored in
Python and held to the ``.cu`` constants here.  The CUDA kernel is held
against both plain versions on the card by ``chip_smoke.py``.
"""

import functools
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu.ops import quantized_matmul as jqm
from deepspeed_tpu_torch.ops import quantization as tq
from deepspeed_tpu_torch.ops import quantized_matmul as tqm

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ROWS = (1, 4, 8, 9, 33, 256)
#: the row counts held against the JAX kernel: one row, two n-tiles of 8
#: and the entry's largest call
JAX_ROWS = (1, 9, 256)

# (K, N, G)
SHAPES = [(k, n, g) for k in (128, 200, 384, 512, 768, 3072)
          for n, g in ((128, 128), (896, 128), (896, 896))] + \
    [(384, 512, 256), (768, 512, 256)]
#: the shapes held against the JAX kernel (interpret mode, ~1.5 s a shape
#: and dtype): every K of the list but 3072, which takes one
JAX_SHAPES = [s for s in SHAPES if s[0] != 3072] + [(3072, 128, 128)]


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    for var in ("DS_W8A8", "DS_QMM", "DS_INDEXED_DECODE"):
        monkeypatch.delenv(var, raising=False)
    jqm.configure(kernel_ok=True)
    tqm.configure(kernel_ok=True)
    yield
    tqm.configure(kernel_ok=True)


@functools.lru_cache(maxsize=None)
def _case(k, n, g):
    """256 activation rows (numpy, float32) and the port's and the JAX
    package's weight-only records of the same [K, N] weight."""
    rng = np.random.default_rng(k + 7 * n + g)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((max(ROWS), k)).astype(np.float32)
    return (x, tq.quantize(torch.from_numpy(w), group_size=g),
            jq.quantize(jnp.asarray(w), group_size=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,g", SHAPES)
def test_split_plain_matches_plain(k, n, g, dtype):
    """Both sum exact bf16 products, the model in f32 by blocks, the plain
    version in float64: fp32 at 1e-5."""
    x, trec, _ = _case(k, n, g)
    xt = torch.from_numpy(x).to(dtype)
    got = tqm.quantized_matmul_split_plain(xt, trec["q"], trec["scale"],
                                           torch.float32)
    want = tqm.quantized_matmul_plain(xt, trec["q"], trec["scale"],
                                      torch.float32)
    assert got.dtype == torch.float32 and got.shape == (max(ROWS), n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n,g", JAX_SHAPES)
def test_split_plain_matches_jax_qmm_call(monkeypatch, k, n, g, dtype):
    monkeypatch.setenv("DS_QMM", "1")
    x, trec, jrec = _case(k, n, g)
    for rows in JAX_ROWS:
        want = jqm.quantized_matmul(jnp.asarray(x[:rows], dtype), jrec)
        got = tqm.quantized_matmul_split_plain(
            torch.from_numpy(x[:rows]).to(getattr(torch, dtype)),
            trec["q"], trec["scale"])
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,g", SHAPES)
def test_rows_equal_the_same_rows_alone(k, n, g, out_dtype):
    """Rows of a 256-row call equal, bit for bit, the same rows of calls
    of 1, 4, 8, 9 and 33 rows and each sampled row alone."""
    x, trec, _ = _case(k, n, g)
    xt = torch.from_numpy(x).to(torch.bfloat16)

    def split(a):
        return tqm.quantized_matmul_split_plain(a, trec["q"], trec["scale"],
                                                out_dtype)

    full = split(xt)
    for rows in ROWS[:-1]:
        assert torch.equal(split(xt[:rows]), full[:rows])
    for r in (0, 1, 7, 8, 32, 100, 255):
        assert torch.equal(split(xt[r:r + 1]), full[r:r + 1])


@pytest.mark.parametrize("k,n,g,cpb", [
    (8, 128, 128, 1), (128, 128, 128, 1), (200, 896, 128, 1),
    (2048, 128, 128, 1), (2056, 128, 128, 2), (3072, 768, 128, 2),
    (4096, 256, 256, 2), (12288, 128, 128, 6), (100000, 128, 128, 49),
    (100, 128, 128, 0), (0, 128, 128, 0), (768, 128, 64, 0),
    (768, 896, 256, 0), (768, 192, 192, 0)])
def test_qmm_chunks_per_block(k, n, g, cpb):
    """The launcher's rule: the fewest 128-row chunks a block that leave
    at most 16 blocks a column tile; 0 where the kernel refuses the
    shape."""
    assert tqm.qmm_chunks_per_block(k, n, g) == cpb
    if cpb:
        chunks = -(-k // tqm.QMM_CHUNK_K)
        assert -(-chunks // cpb) <= 16 and (cpb == 1 or
                                             -(-chunks // (cpb - 1)) > 16)


def test_chunk_rule_takes_no_row_count_and_matches_the_source():
    """The rule's arguments are (K, N, G); the Python constants are the
    ``.cu`` file's, and its C function tests the same refusals."""
    params = list(inspect.signature(tqm.qmm_chunks_per_block).parameters)
    assert params == ["k_dim", "n_dim", "group"]
    src = (Path(tqm.__file__).parent / "csrc" /
           "quantized_matmul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("QM_TN") == tqm.QMM_TILE_N
    assert const("QM_KC") == tqm.QMM_CHUNK_K
    assert const("QM_CLUSTER") == tqm._QMM_CLUSTER
    rule = re.search(r"int qmm_chunks_per_block\(int K, int N, int G\) \{"
                     r"(.*?)\n\}", src, re.S)[1]
    assert "K % 8" in rule and "G % 128" in rule and "N % G" in rule
    assert "M" not in rule.replace("QM_", "")


@pytest.mark.parametrize("k,n,g", [(100, 128, 128), (772, 256, 128),
                                   (256, 128, 64), (256, 384, 192)])
def test_wrapper_refuses_k_and_group_it_cannot_tile(k, n, g):
    """K % 8 != 0 and G % 128 != 0 raise before any launch, on every
    device; the JAX eligibility never sends such a call."""
    q = torch.zeros((k, n), dtype=torch.int8)
    scale = torch.ones((k, n // g), dtype=torch.float32)
    with pytest.raises(ValueError, match="K % 8"):
        tqm.quantized_matmul_cuda(torch.ones((2, k)), q, scale)


def test_wrapper_refuses_mismatched_x_and_scale():
    x, trec, _ = _case(200, 896, 128)
    xt = torch.from_numpy(x[:4])
    with pytest.raises(ValueError, match="does not match"):
        tqm.quantized_matmul_cuda(xt[:, :192], trec["q"], trec["scale"])
    with pytest.raises(ValueError, match="scale"):
        tqm.quantized_matmul_cuda(xt, trec["q"], trec["scale"][:100])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_the_plain_version_uncounted(dtype):
    tqm.reset_launch_counts()
    x, trec, _ = _case(3072, 128, 128)
    xt = torch.from_numpy(x[:9]).to(dtype)
    got = tqm.quantized_matmul_cuda(xt, trec["q"], trec["scale"])
    assert torch.equal(got, tqm.quantized_matmul_plain(xt, trec["q"],
                                                       trec["scale"]))
    assert tqm.quantized_matmul_cuda.launches == 0
