"""Int8 weight matmuls — the PyTorch port of
``deepspeed_tpu/ops/quantized_matmul.py`` (one device; the tensor-parallel
lowerings ``_w8a8_tp_call`` wait for the multi-GPU slice).

Entry points, with the JAX package's signatures and eligibility rules:

 - :func:`w8a8_matmul` (B5): ``x @ dequantize_k(rec)`` for decode-shaped
   ``x`` (at most :data:`W8A8_MAX_ROWS` rows) with the activations
   quantized per (row, k-group) inside the kernel and an int8 x int8 ->
   int32 dot; other shapes, and ``DS_W8A8=0``, take dequantize + matmul.
 - :func:`w8a8_matmul_stacked` (B6): the same on layer ``layer_idx`` of a
   stacked ``[L, K, N]`` record, the index a device int32 scalar read by
   the kernel, so the layer loop never syncs with the host.
 - :func:`quantized_matmul` (B7): ``x @ dequantize(rec)`` for weight-only
   records (groups along N), dequantized to bf16 inside the kernel; opt-in
   through ``DS_QMM=1`` as in the JAX package.

Each kernel wrapper (``w8a8_matmul_cuda``, ``w8a8_matmul_stacked_cuda``,
``quantized_matmul_cuda``) launches its hand-written CUDA kernel
(``ops/csrc/quantized_matmul.cu``, built by ``ops/op_builder.py`` at first
use) on CUDA tensors and adds one to its ``launches`` count, or raises; it
takes its plain PyTorch version (``*_plain``, the same arithmetic in the
same order) only for tensors on the CPU.  B5 and B6 share one kernel,
``w8a8_split_kernel``: a cluster of up to 16 blocks per 64-column tile,
each block on its own k-groups with the int8 tensor cores, keeping their
terms in its shared memory, and the groups' terms summed in group order by
the cluster's first block, which reads the others' through distributed
shared memory;
``w8a8_matmul_split_plain`` models that tiling for the tests and
``chip_smoke.py``.  B7 runs ``qmm_split_kernel``: the same cluster shape
over 128-row k-chunks, the weight tile dequantized in registers into bf16
tensor-core products, each block's term kept in its shared memory and the
terms summed in block order; ``quantized_matmul_split_plain`` models it.
The switches are read at call time, as the JAX package reads them; the
TPU's block-size knobs (``DS_QMM_STEP_MB``, ``DS_QMM_BN``,
``DS_QMM_VMEM_MB``) choose VMEM tiles, change no result, and are not read:
their defaults decide eligibility.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import quantization as quant

#: decode-shaped row cap shared by w8a8_matmul / w8a8_matmul_stacked and the
#: models' indexed-decode gate (gpt2.use_indexed_decode)
W8A8_MAX_ROWS = 8

#: output columns one block of the w8a8 kernel takes (``W8_TN`` in
#: ``csrc/quantized_matmul.cu``)
W8A8_TILE_N = 64
#: blocks of one column tile (a thread-block cluster, ``W8_CLUSTER``) and
#: the k-groups one block may take (``W8_MAX_GPB``: their terms fill its
#: shared memory), so a call takes up to 16 x 104 groups as they divide
_W8A8_CLUSTER = 16
W8A8_MAX_GROUPS_PER_BLOCK = 104

#: the weight-only kernel's column tile, k-chunk and most blocks of a
#: column tile (``QM_TN``, ``QM_KC``, ``QM_CLUSTER`` in
#: ``csrc/quantized_matmul.cu``)
QMM_TILE_N = 64
QMM_CHUNK_K = 128
_QMM_CLUSTER = 16

#: the JAX package's default fetch-block budgets (``DS_QMM_STEP_MB``): the
#: weight-only kernel's 1 MB and the w8a8 kernels' 4 MB
_QMM_STEP_BYTES = 1 << 20
_W8A8_STEP_BYTES = 4 << 20

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_KERNEL_OK = True


def configure(kernel_ok: bool) -> None:
    """Set by the inference engine that owns the current weights (the JAX
    package's single-active-engine contract): ``kernel_ok=False`` sends
    every call to the dequantize + matmul path."""
    global _KERNEL_OK
    _KERNEL_OK = bool(kernel_ok)


def _w8a8_enabled() -> bool:
    return os.environ.get("DS_W8A8", "1") != "0"


def stacked_kernel_enabled() -> bool:
    """True when :func:`w8a8_matmul_stacked` would select the layer
    in-kernel; models gate their layer-indexed decode loop on it."""
    return _KERNEL_OK and _w8a8_enabled()


def _pick_block(dim: int, group: int, cap: int, quantum: int) -> int:
    """Largest divisor of ``dim`` that is <= cap, a multiple of ``quantum``
    and of ``group`` (``quantized_matmul.py:113``)."""
    step = quantum
    while step % group:
        step += quantum
    best = 0
    b = step
    while b <= min(dim, cap):
        if dim % b == 0:
            best = b
        b += step
    return best


def _w8a8_pick_bk(k_dim: int, kg_blocks: int, n_dim: int) -> int:
    """The JAX block sizing's eligibility half (``:312``): 0 when the
    shape cannot tile, so the per-layer and stacked entries stay eligible
    under identical conditions."""
    k_group = k_dim // kg_blocks if kg_blocks else 0
    if not (k_group and k_dim % kg_blocks == 0):
        return 0
    block_k = max(1, _W8A8_STEP_BYTES // max(n_dim, 1))
    return _pick_block(k_dim, k_group, block_k, k_group)


def _rows(lead) -> int:
    rows = 1
    for d in lead:
        rows *= int(d)
    return rows


def _matmul_to(x2d, w, out_dtype):
    """``jax.lax.dot(x2d, w, preferred_element_type=out_dtype)``: the
    product in the wider of the two types, cast to ``out_dtype``."""
    ct = torch.promote_types(x2d.dtype, out_dtype)
    return (x2d.to(ct) @ w.to(ct)).to(out_dtype)


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic, op for op
# ---------------------------------------------------------------------------
def w8a8_matmul_plain(x2d, qk, kscale3, out_dtype=None):
    """x [B, K] float, qk int8 [K, N], kscale f32 [K/G, 1, N] -> [B, N]:
    per k-group in order, ax = max|x| in f32 (0 -> 1), codes = clip(round(x
    * (127/ax)), ±127), the exact integer dot (float64 here), and acc +=
    (float(dot) * (ax/127)) * kscale, cast once (``_w8a8_kernel``); the
    divisions round once, as the kernel's do (``quantization.ieee_div``)."""
    out_dtype = out_dtype or x2d.dtype
    b, k_dim = x2d.shape
    n_dim = qk.shape[1]
    k_group = k_dim // kscale3.shape[0]
    acc = torch.zeros((b, n_dim), dtype=torch.float32, device=x2d.device)
    xf = x2d.to(torch.float32)
    for g in range(k_dim // k_group):
        xt = xf[:, g * k_group:(g + 1) * k_group]
        ax = xt.abs().amax(dim=1, keepdim=True)
        ax = torch.where(ax == 0, torch.ones_like(ax), ax)
        xq = torch.clamp(torch.round(xt * quant.ieee_div(127.0, ax)),
                         -127, 127)
        part = xq.to(torch.float64) @ \
            qk[g * k_group:(g + 1) * k_group].to(torch.float64)
        acc = acc + part.to(torch.float32) * quant.ieee_div(ax, 127.0) * \
            kscale3[g]
    return acc.to(out_dtype)


def w8a8_matmul_split_plain(x2d, qk, kscale3, out_dtype=None, order=None):
    """The w8a8 kernel's tiling in plain PyTorch, for the tests and
    ``chip_smoke.py`` (no serving path calls it): each (column tile of
    :data:`W8A8_TILE_N`, k-group) pair computes its term t_g = (float(dot)
    * (ax/127)) * kscale into a partial ``[K/G, B, N]``, the pairs taken in
    ``order`` (a permutation of ``range(tiles * groups)``, pair ``i`` being
    tile ``i // groups`` and group ``i % groups``; default: last to first),
    as the kernel's blocks run in no order; then the terms are summed in
    group order and cast once.  Same arguments and bits as
    :func:`w8a8_matmul_plain`."""
    out_dtype = out_dtype or x2d.dtype
    b, k_dim = x2d.shape
    n_dim = qk.shape[1]
    groups = kscale3.shape[0]
    k_group = k_dim // groups
    tiles = -(-n_dim // W8A8_TILE_N)
    if order is None:
        order = range(tiles * groups - 1, -1, -1)
    xf = x2d.to(torch.float32)
    # each group's codes and ax/127 are the same for every tile: made once
    codes, dq = [], []
    for g in range(groups):
        xt = xf[:, g * k_group:(g + 1) * k_group]
        ax = xt.abs().amax(dim=1, keepdim=True)
        ax = torch.where(ax == 0, torch.ones_like(ax), ax)
        codes.append(torch.clamp(torch.round(xt * quant.ieee_div(127.0, ax)),
                                 -127, 127).to(torch.float64))
        dq.append(quant.ieee_div(ax, 127.0))
    qk64 = qk.to(torch.float64)
    part = torch.empty((groups, b, n_dim), dtype=torch.float32,
                       device=x2d.device)
    for i in order:
        tile, g = divmod(int(i), groups)
        cols = slice(tile * W8A8_TILE_N, (tile + 1) * W8A8_TILE_N)
        dot = codes[g] @ qk64[g * k_group:(g + 1) * k_group, cols]
        part[g, :, cols] = dot.to(torch.float32) * dq[g] * kscale3[g, :, cols]
    acc = torch.zeros((b, n_dim), dtype=torch.float32, device=x2d.device)
    for g in range(groups):
        acc = acc + part[g]
    return acc.to(out_dtype)


def quantized_matmul_plain(x2d, q, scale, out_dtype=None):
    """x [M, K] float, q int8 [K, N], scale f32 [K, N/G] -> [M, N]:
    ``bf16(x) @ bf16(bf16(q) * bf16(scale))``, rounded to f32 — the
    weight product rounds to bf16 as the TPU kernel's does
    (``quantized_matmul.py:94-98``); this is not :func:`quantization.
    dequantize`, which multiplies in f32.  The products of bf16 values are
    exact and are summed in float64, so a row's result does not depend on
    how many rows the call has (an f32 GEMM picks its summation order from
    the row count)."""
    out_dtype = out_dtype or x2d.dtype
    g = q.shape[1] // scale.shape[1]
    s = scale.to(torch.bfloat16).repeat_interleave(g, dim=1)
    w = q.to(torch.bfloat16) * s
    return (x2d.to(torch.bfloat16).to(torch.float64)
            @ w.to(torch.float64)).to(torch.float32).to(out_dtype)


def quantized_matmul_split_plain(x2d, q, scale, out_dtype=None):
    """The weight-only kernel's tiling in plain PyTorch, for the tests and
    ``chip_smoke.py`` (no serving path calls it): K is cut into the spans
    of :func:`qmm_chunks_per_block` chunks of :data:`QMM_CHUNK_K` rows, one
    span a block; each (block, column tile of :data:`QMM_TILE_N`) pair's
    term is its bf16 products summed exactly (float64) and rounded to f32
    — the kernel sums them on the tensor cores, its chunks in order, so its
    term may differ in the last bits — and the terms are summed in block
    order in f32 and cast once.  Same arguments as
    :func:`quantized_matmul_plain`; a row's result depends on no other
    row."""
    out_dtype = out_dtype or x2d.dtype
    k_dim, n_dim = q.shape
    g = n_dim // scale.shape[1]
    cpb = qmm_chunks_per_block(k_dim, n_dim, g)
    if not cpb:
        raise ValueError(f"quantized_matmul_split_plain: K={k_dim}, N="
                         f"{n_dim}, G={g} does not tile")
    s = scale.to(torch.bfloat16).repeat_interleave(g, dim=1)
    w = (q.to(torch.bfloat16) * s).to(torch.float64)
    xf = x2d.to(torch.bfloat16).to(torch.float64)
    span = cpb * QMM_CHUNK_K
    acc = torch.zeros((x2d.shape[0], n_dim), dtype=torch.float32,
                      device=x2d.device)
    for k0 in range(0, k_dim, span):
        acc = acc + (xf[:, k0:k0 + span] @ w[k0:k0 + span]).to(torch.float32)
    return acc.to(out_dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _lib():
    """The kernels' library, built at first use (never at import)."""
    from .op_builder import builder

    lib = builder("quantized_matmul", ["quantized_matmul.cu"]).load()
    if not getattr(lib, "_ds_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_w8a8_matmul.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.ds_w8a8_matmul_stacked.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.ds_quantized_matmul.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        for fn in (lib.ds_w8a8_matmul, lib.ds_w8a8_matmul_stacked,
                   lib.ds_quantized_matmul):
            fn.restype = ctypes.c_int
        lib._ds_typed = True
    return lib


def w8a8_groups_per_block(groups: int) -> int:
    """k-groups one block of the w8a8 kernel takes (the launcher's rule in
    ``csrc/quantized_matmul.cu``): the fewest that divide ``groups`` and
    leave at most 16 blocks, one cluster, a column tile; 0 when that is
    more than :data:`W8A8_MAX_GROUPS_PER_BLOCK` (a prime count past 104, or
    more than 16 x 104 groups)."""
    if groups < 1:
        return 0
    gpb = -(-groups // _W8A8_CLUSTER)
    while groups % gpb:
        gpb += 1
    return gpb if gpb <= W8A8_MAX_GROUPS_PER_BLOCK else 0


def qmm_chunks_per_block(k_dim: int, n_dim: int, group: int) -> int:
    """k-chunks of :data:`QMM_CHUNK_K` rows one block of the weight-only
    kernel takes (the launcher's rule in ``csrc/quantized_matmul.cu``): the
    fewest that leave at most 16 blocks, one cluster, a column tile; 0 for
    a shape the kernel does not take (K % 8, G % 128 or N % G not 0).  No
    row count enters: a row's sum order is the same in every call."""
    if k_dim < 8 or k_dim % 8 or group < 128 or group % 128 or \
            n_dim % group:
        return 0
    chunks = -(-k_dim // QMM_CHUNK_K)
    return -(-chunks // _QMM_CLUSTER)


def _check(name, x2d, out_dtype, tensors):
    """Device, dtype, layout and alignment checks before a launch."""
    for tname, t, dtype in tensors:
        if not t.is_cuda or t.device != x2d.device:
            raise ValueError(f"{name}: {tname} must be a CUDA tensor on "
                             f"{x2d.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {tname} must be {dtype}, got "
                             f"{t.dtype}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: {tname} is not 4-byte aligned")
    for tname, dt in (("x", x2d.dtype), ("out", out_dtype)):
        if dt not in _DTYPE_CODES:
            raise ValueError(f"{name}: {tname} dtype {dt} not supported "
                             "(float32, float16, bfloat16)")


def _check_scale_alignment(name, kscale):
    """The kernel reads 4 scales at a time."""
    if kscale.data_ptr() % 16:
        raise ValueError(f"{name}: kscale is not 16-byte aligned")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(device) -> int:
    """The current stream's handle on ``device``, without building a
    ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check_w8a8_shapes(name, x2d, k_dim, n_dim, k_group):
    b = x2d.shape[0]
    if x2d.ndim != 2 or x2d.shape[1] != k_dim:
        raise ValueError(f"{name}: x {tuple(x2d.shape)} does not match K="
                         f"{k_dim}")
    if not 1 <= b <= W8A8_MAX_ROWS:
        raise ValueError(f"{name}: takes 1..{W8A8_MAX_ROWS} rows, got {b}")
    if n_dim % 128 or not k_group or k_dim % k_group:
        raise ValueError(f"{name}: N={n_dim} must be a multiple of 128 and "
                         f"K={k_dim} whole k-groups of {k_group}")
    if not w8a8_groups_per_block(k_dim // k_group):
        raise ValueError(f"{name}: K/G={k_dim // k_group} k-groups do not "
                         f"split into at most 16 blocks of "
                         f"{W8A8_MAX_GROUPS_PER_BLOCK}")


def w8a8_matmul_cuda(x2d, qk, kscale3, out_dtype=None):
    """B5: x [B <= 8, K] float against qk int8 [K, N], kscale f32
    [K/G, 1, N] -> [B, N] in ``out_dtype`` (default x's).  Replaces
    ``_w8a8_call``."""
    if not x2d.is_cuda:
        return w8a8_matmul_plain(x2d, qk, kscale3, out_dtype)
    name = "w8a8_matmul_cuda"
    out_dtype = out_dtype or x2d.dtype
    k_dim, n_dim = qk.shape
    k_group = k_dim // kscale3.shape[0]
    _check_w8a8_shapes(name, x2d, k_dim, n_dim, k_group)
    if tuple(kscale3.shape) != (k_dim // k_group, 1, n_dim):
        raise ValueError(f"{name}: kscale {tuple(kscale3.shape)} does not "
                         f"match qk {tuple(qk.shape)}")
    _check(name, x2d, out_dtype, (("x", x2d, None), ("qk", qk, torch.int8),
                                  ("kscale", kscale3, torch.float32)))
    _check_scale_alignment(name, kscale3)
    out = torch.empty((x2d.shape[0], n_dim), dtype=out_dtype,
                      device=x2d.device)
    err = _lib().ds_w8a8_matmul(
        x2d.data_ptr(), qk.data_ptr(), kscale3.data_ptr(), out.data_ptr(),
        x2d.shape[0], k_dim, n_dim, k_group, _DTYPE_CODES[x2d.dtype],
        _DTYPE_CODES[out_dtype], _stream(x2d.device))
    _raise_on_error(name, err)
    w8a8_matmul_cuda.launches += 1
    return out


w8a8_matmul_cuda.launches = 0


def w8a8_matmul_stacked_cuda(layer_idx, x2d, qks, kscales, out_dtype=None):
    """B6: B5 on layer ``layer_idx`` of qks int8 [L, K, N], kscales f32
    [L, K/G, 1, N].  ``layer_idx`` is an int32 tensor of one element on
    x's device (e.g. a slice of a preallocated ``arange(L)``), read by the
    kernel and clamped to [0, L) as ``dynamic_index_in_dim`` clamps; no
    host sync.  Replaces ``_w8a8_stacked_call``."""
    if not x2d.is_cuda:
        l_idx = min(max(int(layer_idx), 0), qks.shape[0] - 1)
        return w8a8_matmul_plain(x2d, qks[l_idx], kscales[l_idx], out_dtype)
    name = "w8a8_matmul_stacked_cuda"
    out_dtype = out_dtype or x2d.dtype
    n_layers, k_dim, n_dim = qks.shape
    k_group = k_dim // kscales.shape[1]
    _check_w8a8_shapes(name, x2d, k_dim, n_dim, k_group)
    if tuple(kscales.shape) != (n_layers, k_dim // k_group, 1, n_dim):
        raise ValueError(f"{name}: kscales {tuple(kscales.shape)} do not "
                         f"match qks {tuple(qks.shape)}")
    if not isinstance(layer_idx, torch.Tensor) or layer_idx.numel() != 1:
        raise ValueError(f"{name}: layer_idx must be a one-element int32 "
                         f"tensor on the card, got {layer_idx!r}")
    _check(name, x2d, out_dtype, (("x", x2d, None), ("qks", qks, torch.int8),
                                  ("kscales", kscales, torch.float32),
                                  ("layer_idx", layer_idx, torch.int32)))
    _check_scale_alignment(name, kscales)
    out = torch.empty((x2d.shape[0], n_dim), dtype=out_dtype,
                      device=x2d.device)
    err = _lib().ds_w8a8_matmul_stacked(
        layer_idx.data_ptr(), x2d.data_ptr(), qks.data_ptr(),
        kscales.data_ptr(), out.data_ptr(), n_layers, x2d.shape[0], k_dim,
        n_dim, k_group, _DTYPE_CODES[x2d.dtype], _DTYPE_CODES[out_dtype],
        _stream(x2d.device))
    _raise_on_error(name, err)
    w8a8_matmul_stacked_cuda.launches += 1
    return out


w8a8_matmul_stacked_cuda.launches = 0


def quantized_matmul_cuda(x2d, q, scale, out_dtype=None):
    """B7: x [M, K] float against a weight-only record q int8 [K, N],
    scale f32 [K, N/G] with K % 8 == 0 and G % 128 == 0 -> [M, N], any M
    >= 1.  Replaces ``_qmm_call``.  The shapes are checked on every
    device; a CPU tensor then takes the plain version."""
    name = "quantized_matmul_cuda"
    k_dim, n_dim = q.shape
    if x2d.ndim != 2 or x2d.shape[1] != k_dim or x2d.shape[0] < 1:
        raise ValueError(f"{name}: x {tuple(x2d.shape)} does not match K="
                         f"{k_dim}")
    groups = scale.shape[1] if scale.ndim == 2 else 0
    g = n_dim // groups if groups and n_dim % groups == 0 else 0
    if tuple(scale.shape) != (k_dim, groups) or \
            not qmm_chunks_per_block(k_dim, n_dim, g):
        raise ValueError(f"{name}: q {tuple(q.shape)} with scale "
                         f"{tuple(scale.shape)} must be K % 8 == 0 rows in "
                         "groups of G % 128 == 0 columns, scale [K, N/G]")
    if not x2d.is_cuda:
        return quantized_matmul_plain(x2d, q, scale, out_dtype)
    out_dtype = out_dtype or x2d.dtype
    _check(name, x2d, out_dtype, (("x", x2d, None), ("q", q, torch.int8),
                                  ("scale", scale, torch.float32)))
    if x2d.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{name}: x and q must be 16-byte aligned")
    out = torch.empty((x2d.shape[0], n_dim), dtype=out_dtype,
                      device=x2d.device)
    err = _lib().ds_quantized_matmul(
        x2d.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        x2d.shape[0], k_dim, n_dim, g, _DTYPE_CODES[x2d.dtype],
        _DTYPE_CODES[out_dtype], _stream(x2d.device))
    _raise_on_error(name, err)
    quantized_matmul_cuda.launches += 1
    return out


quantized_matmul_cuda.launches = 0

#: every kernel wrapper of this module, for launch-count bookkeeping
KERNELS = (w8a8_matmul_cuda, w8a8_matmul_stacked_cuda, quantized_matmul_cuda)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Entry points (the JAX package's eligibility, rule for rule)
# ---------------------------------------------------------------------------
def quantized_matmul(x, rec: dict, out_dtype=None, *, max_rows: int = 256):
    """``x @ dequantize(rec)`` for a weight-only record without
    materializing the weight (``quantized_matmul.py:158``).  The kernel
    runs under ``DS_QMM=1`` for a symmetric 2-D record with G % 128 == 0 at
    most ``min(max_rows, max(8, 2**19 // N))`` rows whose K tiles; every
    other call takes dequantize + matmul."""
    q, scale = rec["q"], rec["scale"]
    k_dim, n_dim = q.shape[-2], q.shape[-1]
    lead = tuple(x.shape[:-1])
    rows = _rows(lead)
    g = n_dim // scale.shape[-1]
    bn = n_dim
    block_k = max(1, _QMM_STEP_BYTES // max(bn, 1))
    bk = _pick_block(k_dim, 1, block_k, 256) or \
        _pick_block(k_dim, 1, block_k, 8)
    row_cap = min(max_rows, max(8, (2 ** 19) // max(bn, 1)))
    eligible = (
        _KERNEL_OK
        and os.environ.get("DS_QMM", "0") == "1"
        and q.ndim == 2
        and "zero" not in rec
        and rows <= row_cap
        and g % 128 == 0
        and bk > 0 and bn >= g
    )
    if not eligible:
        return x @ quant.dequantize(rec, x.dtype)
    out = quantized_matmul_cuda(x.reshape(rows, k_dim), q, scale,
                                out_dtype or x.dtype)
    return out.reshape(lead + (n_dim,))


def _w8a8_local(x2d, qk, kscale3, out_dtype=None):
    """The kernel when the shapes tile (N a multiple of 128, whole
    k-groups), exact dequantize + matmul otherwise (``:325``)."""
    out_dtype = out_dtype or x2d.dtype
    k_dim, n_dim = qk.shape
    if (_w8a8_pick_bk(k_dim, kscale3.shape[0], n_dim) > 0
            and n_dim % 128 == 0 and _w8a8_enabled()):
        return w8a8_matmul_cuda(x2d, qk, kscale3, out_dtype)
    deq = quant.dequantize_k({"qk": qk, "kscale": kscale3}, x2d.dtype)
    return _matmul_to(x2d, deq, out_dtype)


def w8a8_matmul(x, rec: dict, out_dtype=None, *,
                max_rows: int = W8A8_MAX_ROWS):
    """``x @ dequantize_k(rec)`` with in-kernel activation quantization
    for decode-shaped inputs (``rows <= max_rows``); other shapes — and
    ``DS_W8A8=0`` — take dequantize + matmul, which keeps a prefill's
    activations unquantized (``quantized_matmul.py:463``)."""
    qk, kscale = rec["qk"], rec["kscale"]
    k_dim, n_dim = qk.shape[-2], qk.shape[-1]
    k_group = k_dim // kscale.shape[-3]
    lead = tuple(x.shape[:-1])
    rows = _rows(lead)
    if qk.ndim == 2 and rows <= max_rows and _w8a8_enabled():
        if not _KERNEL_OK:
            return x @ quant.dequantize_k(rec, x.dtype)
        out = _w8a8_local(x.reshape(rows, k_dim), qk,
                          kscale.reshape(k_dim // k_group, 1, n_dim),
                          out_dtype)
        return out.to(out_dtype or x.dtype).reshape(lead + (n_dim,))
    return x @ quant.dequantize_k(rec, x.dtype)


def w8a8_matmul_stacked(x, rec: dict, layer_idx, out_dtype=None, *,
                        max_rows: int = W8A8_MAX_ROWS):
    """``x @ dequantize_k(rec[layer_idx])`` with the layer selected inside
    the kernel (``:563``).  ``rec`` holds stacked records (``qk [L, K,
    N]``, ``kscale [L, K/G, 1, N]``); ``layer_idx`` is a one-element int32
    tensor on x's device.  Shapes the kernel cannot tile fall back to the
    sliced layer through :func:`w8a8_matmul`."""
    qk, kscale = rec["qk"], rec["kscale"]
    if qk.ndim != 3:
        raise ValueError("w8a8_matmul_stacked takes stacked records; use "
                         "w8a8_matmul for a 2-D one")
    k_dim, n_dim = qk.shape[-2], qk.shape[-1]
    lead = tuple(x.shape[:-1])
    rows = _rows(lead)
    eligible = (rows <= max_rows
                and _w8a8_pick_bk(k_dim, kscale.shape[-3], n_dim) > 0
                and n_dim % 128 == 0 and stacked_kernel_enabled())
    if eligible:
        out = w8a8_matmul_stacked_cuda(layer_idx, x.reshape(rows, k_dim), qk,
                                       kscale, out_dtype or x.dtype)
        return out.reshape(lead + (n_dim,))
    layer = {"qk": qk[layer_idx], "kscale": kscale[layer_idx]}
    return w8a8_matmul(x, layer, out_dtype=out_dtype, max_rows=max_rows)
