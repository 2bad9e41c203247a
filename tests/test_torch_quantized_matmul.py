"""The PyTorch port's int8 matmuls (``deepspeed_tpu_torch/ops/
quantized_matmul.py``) against the JAX package's, whose Pallas kernels run
in interpret mode on the CPU as its own tests run them.

On the CPU the port's wrappers take their plain versions, so each case
holds the port's arithmetic (in-kernel activation quantization, the int8
dot, the scale order, the bf16 weight rounding of B7) against the JAX
kernel's at rows 1, 4 and 8: fp32 at rtol 1e-5 (the frameworks sum in
different orders), bf16 at 2e-2 (one bf16 ulp of the output).  Ineligible
shapes and switched-off kernels must take the JAX package's fallback, which
the same comparison shows: the fallback's arithmetic differs from the
kernels'.  The CUDA kernels are held against the plain versions on the card
by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu.ops import quantized_matmul as jqm
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import quantization as tq
from deepspeed_tpu_torch.ops import quantized_matmul as tqm

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    for var in ("DS_W8A8", "DS_QMM", "DS_INDEXED_DECODE"):
        monkeypatch.delenv(var, raising=False)
    jqm.configure(kernel_ok=True)
    tqm.configure(kernel_ok=True)
    yield
    tqm.configure(kernel_ok=True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(k, n, layers=3, rows=8, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((layers, k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[2, :k // 4] = 0.0                         # a zero k-group: ax -> 1
    return w, x


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_w8a8_matmul_matches_jax(dtype, rows):
    w, x = _inputs(512, 256)
    jrec = jq.quantize_k_grouped(jnp.asarray(w[1]), 128)
    trec = tq.quantize_k_grouped(torch.from_numpy(w[1]), 128)
    xj, xt = jnp.asarray(x[:rows], dtype), _t(x[:rows]).to(getattr(torch,
                                                                  dtype))
    want = jqm.w8a8_matmul(xj, jrec)
    got = tqm.w8a8_matmul(xt, trec)
    assert got.dtype == xt.dtype and tuple(got.shape) == (rows, 256)
    _close(got, want, dtype)
    # 3-D activations and an f32 out_dtype, as the JAX entry takes them
    want = jqm.w8a8_matmul(xj.reshape(1, rows, 512), jrec,
                           out_dtype=jnp.float32)
    got = tqm.w8a8_matmul(xt.reshape(1, rows, 512), trec,
                          out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, rows, 256)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_w8a8_matmul_stacked_matches_jax_and_per_layer(dtype, rows):
    w, x = _inputs(256, 384, seed=1)
    jrec = jq.quantize_k_grouped(jnp.asarray(w), 128)
    trec = tq.quantize_k_grouped(torch.from_numpy(w), 128)
    xt = _t(x[:rows]).to(getattr(torch, dtype))
    ids = torch.arange(3, dtype=torch.int32)
    for l in range(3):
        want = jqm.w8a8_matmul_stacked(jnp.asarray(x[:rows], dtype), jrec,
                                       jnp.int32(l))
        got = tqm.w8a8_matmul_stacked(xt, trec, ids[l:l + 1])
        _close(got, want, dtype)
        per_layer = tqm.w8a8_matmul(
            xt, {"qk": trec["qk"][l], "kscale": trec["kscale"][l]})
        assert torch.equal(got, per_layer)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_quantized_matmul_matches_jax(monkeypatch, dtype, rows):
    monkeypatch.setenv("DS_QMM", "1")
    w, x = _inputs(512, 512, seed=2)
    jrec = jq.quantize(jnp.asarray(w[0]), group_size=128)
    trec = tq.quantize(torch.from_numpy(w[0]), group_size=128)
    xj, xt = jnp.asarray(x[:rows], dtype), _t(x[:rows]).to(getattr(torch,
                                                                  dtype))
    want = jqm.quantized_matmul(xj, jrec)
    got = tqm.quantized_matmul(xt, trec)
    assert got.dtype == xt.dtype
    _close(got, want, dtype)
    # the bf16 weight rounding is the kernel's, not dequantize()'s f32 one
    f32 = tqm.quantized_matmul_plain(_t(x[:rows]), trec["q"], trec["scale"])
    deq = _t(x[:rows]).to(torch.bfloat16).float() @ \
        tq.dequantize(trec, torch.float32)
    assert not torch.equal(f32, deq)


def _fallback_cases():
    w, x = _inputs(256, 96, seed=3)              # N % 128 != 0
    w2, x2 = _inputs(256, 256, seed=4)
    return [
        ("w8a8 N=96", "w8a8", w[0], x[:4], 128, {}),
        ("w8a8 rows > 8", "w8a8", w2[0], np.concatenate([x2, x2]), 128, {}),
        ("w8a8 DS_W8A8=0", "w8a8", w2[0], x2[:4], 128, {"DS_W8A8": "0"}),
        ("qmm off by default", "qmm", w2[0], x2[:4], 128, {}),
        ("qmm g=64", "qmm", w2[0], x2[:4], 64, {"DS_QMM": "1"}),
        ("qmm asymmetric", "qmm", w2[0], x2[:4], 128, {"DS_QMM": "1",
                                                       "zero": True}),
        ("qmm rows > row cap", "qmm", w2[0], np.tile(x2, (33, 1)), 128,
         {"DS_QMM": "1"}),
    ]


@pytest.mark.parametrize("case", _fallback_cases(), ids=lambda c: c[0])
def test_ineligible_shapes_fall_back_as_in_jax(monkeypatch, case):
    label, kind, w, x, g, env = case
    env = dict(env)
    symmetric = not env.pop("zero", False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    if kind == "w8a8":
        want = jqm.w8a8_matmul(jnp.asarray(x), jq.quantize_k_grouped(
            jnp.asarray(w), g))
        got = tqm.w8a8_matmul(_t(x), tq.quantize_k_grouped(_t(w), g))
        deq = _t(x) @ tq.dequantize_k(tq.quantize_k_grouped(_t(w), g),
                                      torch.float32)
    else:
        want = jqm.quantized_matmul(jnp.asarray(x), jq.quantize(
            jnp.asarray(w), group_size=g, symmetric=symmetric))
        trec = tq.quantize(_t(w), group_size=g, symmetric=symmetric)
        got = tqm.quantized_matmul(_t(x), trec)
        deq = _t(x) @ tq.dequantize(trec, torch.float32)
    _close(got, want, "float32")
    np.testing.assert_allclose(_np(got), _np(deq), rtol=1e-6, atol=1e-6)
    assert all(fn.launches == 0 for fn in tqm.KERNELS)


def test_configure_and_switches_gate_the_kernels(monkeypatch):
    """``configure(kernel_ok=False)`` and ``DS_W8A8=0`` send w8a8 to the
    dequantize path and turn the indexed decode off, as in JAX; so do
    unquantized blocks and calls of more than ``W8A8_MAX_ROWS`` rows."""
    from deepspeed_tpu.models.gpt2 import use_indexed_decode as j_use

    w, x = _inputs(256, 256, seed=5)
    trec = tq.quantize_k_grouped(_t(w), 128)
    jrec = jq.quantize_k_grouped(jnp.asarray(w), 128)
    tblocks, jblocks = {"qkv_w": trec}, {"qkv_w": jrec}
    assert tgpt2.use_indexed_decode(tblocks, rows=8)
    assert j_use(jblocks, rows=8)
    assert not tgpt2.use_indexed_decode(tblocks, rows=9)
    assert not tgpt2.use_indexed_decode({"qkv_w": _t(w)}, rows=1)
    for var in ("DS_W8A8", "DS_INDEXED_DECODE"):
        monkeypatch.setenv(var, "0")
        assert not tgpt2.use_indexed_decode(tblocks) and \
            not j_use(jblocks)
        monkeypatch.delenv(var)
    layer = {"qk": trec["qk"][0], "kscale": trec["kscale"][0]}
    kernel_path = tqm.w8a8_matmul(_t(x[:2]), layer)
    tqm.configure(kernel_ok=False)
    jqm.configure(kernel_ok=False)
    try:
        assert not tgpt2.use_indexed_decode(tblocks)
        assert not j_use(jblocks)
        got = tqm.w8a8_matmul(_t(x[:2]), layer)
        want = jqm.w8a8_matmul(jnp.asarray(x[:2]), {
            "qk": jrec["qk"][0], "kscale": jrec["kscale"][0]})
        _close(got, want, "float32")
        assert not torch.equal(got, kernel_path)
    finally:
        jqm.configure(kernel_ok=True)
    assert tqm.W8A8_MAX_ROWS == jqm.W8A8_MAX_ROWS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_are_row_invariant(dtype):
    """A row's result is the same bits in a 1-, 4- or 8-row call — what
    lets ``generate`` at batch 4 and the 8-slot server agree."""
    for k, n in ((768, 256), (3072, 128)):
        w, x = _inputs(k, n, layers=1, seed=k + n)
        krec = tq.quantize_k_grouped(_t(w[0]), 128)
        wrec = tq.quantize(_t(w[0]), group_size=128)
        x8 = _t(x).to(dtype)
        for fn in (lambda a: tqm.w8a8_matmul_plain(a, krec["qk"],
                                                   krec["kscale"]),
                   lambda a: tqm.quantized_matmul_plain(a, wrec["q"],
                                                        wrec["scale"])):
            full = fn(x8)
            assert torch.equal(fn(x8[:4]), full[:4])
            for r in range(8):
                assert torch.equal(fn(x8[r:r + 1]), full[r:r + 1])


def test_cpu_wrappers_take_the_plain_versions_and_never_count():
    tqm.reset_launch_counts()
    w, x = _inputs(256, 256, seed=6)
    krec = tq.quantize_k_grouped(_t(w), 128)
    wrec = tq.quantize(_t(w[0]), group_size=128)
    xt = _t(x[:4])
    assert torch.equal(
        tqm.w8a8_matmul_cuda(xt, krec["qk"][1], krec["kscale"][1]),
        tqm.w8a8_matmul_plain(xt, krec["qk"][1], krec["kscale"][1]))
    assert torch.equal(
        tqm.w8a8_matmul_stacked_cuda(torch.tensor([1], dtype=torch.int32), xt,
                                     krec["qk"], krec["kscale"]),
        tqm.w8a8_matmul_plain(xt, krec["qk"][1], krec["kscale"][1]))
    assert torch.equal(tqm.quantized_matmul_cuda(xt, wrec["q"], wrec["scale"]),
                       tqm.quantized_matmul_plain(xt, wrec["q"],
                                                  wrec["scale"]))
    assert [fn.launches for fn in tqm.KERNELS] == [0, 0, 0]
