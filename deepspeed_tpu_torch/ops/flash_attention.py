"""Flash attention, forward and backward — the PyTorch port of
``deepspeed_tpu/ops/flash_attention.py``.

Layout as in the JAX package: q ``[B, H, Sq, D]``, k and v
``[B, Hkv, Sk, D]`` with ``Hkv | H`` (GQA: query head ``h`` reads KV head
``h // (H // Hkv)``, the JAX ``head_rep``); the causal mask is top-left
aligned (key ``<=`` query row, as ``tril(ones(Sq, Sk))``); the row
log-sum-exp is natural-log ``[B, H, Sq]`` float32, the format of the JAX
``_fwd`` (v1).

Three kinds of function:
 - the plain versions, ``flash_attention_fwd_plain`` (``(o, lse)``),
   ``flash_attention_bwd_dq_plain`` / ``flash_attention_bwd_dkv_plain``
   (given lse and ``delta = rowsum(dO * O)``) and
   ``flash_attention_bwd_plain`` (the textbook recompute backward), plus
   ``mha_reference``: plain PyTorch in float32 (float64 stays float64).
   They serve every CPU call and the tests' comparisons.
   ``flash_attention_bwd_dq_tiled_plain`` / ``_dkv_tiled_plain`` model the
   bf16 backward kernels' tiling and rounding, for the tests and
   ``chip_smoke.py``; no training path calls them.
 - the kernel wrappers ``flash_attention_fwd_cuda``,
   ``flash_attention_bwd_dq_cuda`` and ``flash_attention_bwd_dkv_cuda``:
   hand-written CUDA kernels for Hopper (``ops/csrc/flash_attention.cu``,
   built by ``ops/op_builder.py``).  Given CUDA tensors a wrapper launches
   its kernel and adds one to its ``launches`` count, or raises; it takes
   its plain version only for tensors that lie on the CPU.  Each entry
   point picks its kernel by dtype (:func:`bwd_route` names the backward's
   choice): bf16 runs the Hopper kernels (wgmma products, TMA loads,
   register-resident score and gradient tiles), float32 plain-f32 tile
   kernels (the tensor cores would round f32 to tf32).  The forward kernels and the
   dq/dkv pair compute what the JAX package's seven
   ``pallas_call`` sites compute (v1, v2 and v3 differ only in how they fit
   the TPU's VMEM).  The three wrappers are also the ring-attention
   building blocks (``parallel/sequence.py`` calls ``_fwd``,
   ``_bwd_dq_call`` and ``_bwd_dkv_call``): a forward that returns the lse,
   and dq and dkv calls that take a given lse and delta.
 - ``flash_attention``, the JAX entry point's signature over
   ``_FlashAttention`` (a ``torch.autograd.Function`` whose backward runs
   the dq and dkv wrappers).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: head dims the library is built for (GPT-2's 64)
_HEAD_DIMS = (64,)
#: dtype codes of the library (float16 comes with the port's fp16 slice)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _scale(sm_scale, d) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


def _compute_dtype(x):
    """float32 for float32/bfloat16 inputs; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def _expand_kv(q, kv):
    """KV heads repeated to the query heads (GQA), in the compute dtype."""
    rep = q.shape[1] // kv.shape[1]
    kv = kv.to(_compute_dtype(q))
    return kv.repeat_interleave(rep, dim=1) if rep > 1 else kv


def _visible(sq, sk, causal, device):
    """[Sq, Sk] bool mask, or None when every key is visible."""
    if not causal:
        return None
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril()


def _scores(q, k, causal, sm_scale):
    """Scaled scores ``q k^T`` [B, H, Sq, Sk] in the compute dtype, masked
    entries at ``DEFAULT_MASK_VALUE``; and the mask."""
    cd = _compute_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(cd), _expand_kv(q, k))
    s = s * _scale(sm_scale, q.shape[-1])
    mask = _visible(q.shape[2], k.shape[2], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    return s, mask


def mha_reference(q, k, v, causal: bool = True,
                  sm_scale: Optional[float] = None):
    """Plain einsum attention (the thing the kernel replaces,
    ``flash_attention.py:1053``)."""
    s, _ = _scores(q, k, causal, sm_scale)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, _expand_kv(q, v)).to(q.dtype)


def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None):
    """``(o, lse)``: o ``[B, H, Sq, D]`` in q's dtype and the natural-log
    row log-sum-exp ``[B, H, Sq]`` of the scaled, masked scores."""
    s, _ = _scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, _expand_kv(q, v))
    return o.to(q.dtype), lse


def _probs(q, k, lse, causal, sm_scale):
    """Softmax probabilities rebuilt from the lse, zero where masked."""
    s, mask = _scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    return p if mask is None else torch.where(mask, p, 0.0)


def _dscores(q, k, v, do, lse, delta, causal, sm_scale):
    """(p, ds) with ds = p * (dO v^T - delta), both [B, H, Sq, Sk]."""
    p = _probs(q, k, lse, causal, sm_scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(p.dtype), _expand_kv(q, v))
    return p, p * (dp - delta.to(p.dtype)[..., None])


def _sum_groups(x, hkv):
    """[B, H, S, D] summed over the ``H // hkv`` query heads of each KV
    head -> [B, hkv, S, D]."""
    b, h, s, d = x.shape
    return x.reshape(b, hkv, h // hkv, s, d).sum(2)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                                 sm_scale: Optional[float] = None):
    """dq given the forward's lse and ``delta = rowsum(dO * O)``."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _expand_kv(q, k))
    return (dq * _scale(sm_scale, q.shape[-1])).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                                  sm_scale: Optional[float] = None):
    """(dk, dv) given lse and delta, summed over each KV head's query
    heads."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, sm_scale)
    hkv = k.shape[1]
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(p.dtype))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(p.dtype))
    dk = dk * _scale(sm_scale, q.shape[-1])
    return (_sum_groups(dk, hkv).to(k.dtype), _sum_groups(dv, hkv).to(v.dtype))


#: keys a tile of the bf16 dq kernel (``wgmma_dq_kernel``), and queries a
#: tile of the bf16 dkv kernel (``wgmma_dkv_kernel``)
BWD_TILE = 64


def flash_attention_bwd_dq_tiled_plain(q, k, v, do, lse, delta,
                                       causal: bool = True,
                                       sm_scale: Optional[float] = None):
    """``wgmma_dq_kernel``'s algorithm in plain PyTorch (float32; float64
    stays float64): the keys cut into tiles of ``BWD_TILE`` from key 0;
    per tile S = q k^T and dP = dO v^T, P = exp2(S sm_scale log2(e) - lse
    log2(e)) (zero where masked), dS = P (dP - delta) rounded to q's dtype,
    and dq += dS k summed over the tiles in key order; then dq * sm_scale
    rounded to q's dtype."""
    cd = _compute_dtype(q)
    scale = _scale(sm_scale, q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    qc, doc = q.to(cd), do.to(cd)
    kc, vc = _expand_kv(q, k), _expand_kv(q, v)
    lse2 = (lse.to(cd) * math.log2(math.e))[..., None]
    dl = delta.to(cd)[..., None]
    rows = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros(qc.shape, dtype=cd, device=q.device)
    for k0 in range(0, sk, BWD_TILE):
        kt, vt = kc[:, :, k0:k0 + BWD_TILE], vc[:, :, k0:k0 + BWD_TILE]
        s = torch.matmul(qc, kt.transpose(-1, -2))
        dp = torch.matmul(doc, vt.transpose(-1, -2))
        p = torch.exp2(s * (scale * math.log2(math.e)) - lse2)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None]
            p = torch.where(cols <= rows, p, 0.0)
        ds = (p * (dp - dl)).to(q.dtype).to(cd)
        dq = dq + torch.matmul(ds, kt)
    return (dq * scale).to(q.dtype)


def flash_attention_bwd_dkv_tiled_plain(q, k, v, do, lse, delta,
                                        causal: bool = True,
                                        sm_scale: Optional[float] = None):
    """``wgmma_dkv_kernel``'s algorithm in plain PyTorch (float32; float64
    stays float64), on the transposed problem: for each KV head, its rep
    query heads in order and each head's queries in tiles of ``BWD_TILE``
    from row 0, S^T = k q^T and dP^T = v dO^T, P^T =
    exp2(S^T sm_scale log2(e) - lse log2(e)) taken by column (zero where
    masked), dS^T = P^T (dP^T - delta); P^T and dS^T rounded to q's dtype,
    dv += P^T dO and dk += dS^T q summed in that order; then dk * sm_scale
    and dv rounded to k's dtype.  Key rows are independent, so the
    kernel's 128-key tiles need no loop here; a query tile that lies
    wholly above a key's diagonal adds zeros, as the kernel's skipped tiles
    do."""
    cd = _compute_dtype(q)
    scale = _scale(sm_scale, q.shape[-1])
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    kc, vc = k.to(cd), v.to(cd)
    log2e = math.log2(math.e)
    keys = torch.arange(sk, device=q.device)[:, None]
    dk = torch.zeros(kc.shape, dtype=cd, device=q.device)
    dv = torch.zeros(vc.shape, dtype=cd, device=q.device)
    for g in range(rep):
        # query head kvh * rep + g of each KV head kvh
        qh = q.reshape(b, hkv, rep, sq, d)[:, :, g].to(cd)
        doh = do.reshape(b, hkv, rep, sq, d)[:, :, g].to(cd)
        lh = lse.reshape(b, hkv, rep, sq)[:, :, g].to(cd) * log2e
        dh = delta.reshape(b, hkv, rep, sq)[:, :, g].to(cd)
        for q0 in range(0, sq, BWD_TILE):
            rows = slice(q0, q0 + BWD_TILE)
            qt, do_t = qh[:, :, rows], doh[:, :, rows]
            st = torch.matmul(kc, qt.transpose(-1, -2))
            dpt = torch.matmul(vc, do_t.transpose(-1, -2))
            pt = torch.exp2(st * (scale * log2e) - lh[:, :, None, rows])
            if causal:
                cols = torch.arange(q0, q0 + qt.shape[2], device=q.device)
                pt = torch.where(keys <= cols[None], pt, 0.0)
            dst = pt * (dpt - dh[:, :, None, rows])
            dv = dv + torch.matmul(pt.to(q.dtype).to(cd), do_t)
            dk = dk + torch.matmul(dst.to(q.dtype).to(cd), qt)
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """rowsum(dO * O) in the compute dtype, [B, H, Sq]."""
    cd = _compute_dtype(o)
    return (do.to(cd) * o.to(cd)).sum(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              sm_scale: Optional[float] = None):
    """The recompute backward: (dq, dk, dv) from the forward's o and lse."""
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                      sm_scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                           sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _lib():
    """The kernels' library, built at first use (never at import)."""
    from .op_builder import builder

    lib = builder("flash_attention", ["flash_attention.cu"]).load()
    if not getattr(lib, "_ds_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ds_flash_attention_fwd.argtypes = [p, p, p, p, p] + [i] * 7 + [f, p]
        lib.ds_flash_attention_bwd_dq.argtypes = [p] * 8 + [i] * 7 + [f, p]
        lib.ds_flash_attention_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [f, p]
        for fn in (lib.ds_flash_attention_fwd, lib.ds_flash_attention_bwd_dq,
                   lib.ds_flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
        lib._ds_typed = True
    return lib


def bwd_route(dtype) -> str:
    """The backward kernels inputs of ``dtype`` run, by the rule of the
    library's entry points: ``"wgmma"`` (``wgmma_dq_kernel`` and
    ``wgmma_dkv_kernel``: wgmma products, TMA loads, register-resident
    tiles) for bfloat16, ``"tile"`` (``dq_kernel`` and ``dkv_kernel``, plain
    f32 products) for float32, whose tensor-core products would round to
    tf32; raises for any other dtype."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "tile"
    raise ValueError(f"flash attention backward: dtype {dtype} not supported "
                     "(float32, bfloat16; float16 comes with the fp16 slice)")


def _check_cuda(name, q, k, v, *rest):
    """Validate what the kernels take; raises on anything else.  ``rest``:
    (label, tensor, dtype or None for q's dtype, shape)."""
    b, h, sq, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[3] != d or \
            v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: {h} query heads do not group over {hkv} "
                         "KV heads")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, "
                         "bfloat16; float16 comes with the fp16 slice)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if sq < 1 or sk < 1:
        raise ValueError(f"{name}: empty sequence (Sq={sq}, Sk={sk})")
    for label, x, dtype, shape in (("q", q, None, None), ("k", k, None, None),
                                   ("v", v, None, None)) + rest:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name}: {label} must be a CUDA tensor on "
                             f"{q.device}, got {x.device}")
        if x.dtype != (dtype or q.dtype):
            raise ValueError(f"{name}: {label} is {x.dtype}, expected "
                             f"{dtype or q.dtype}")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {label} is not 16-byte aligned")
    return b, h, hkv, sq, sk, d


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd_cuda(q, k, v, causal: bool = True,
                             sm_scale: Optional[float] = None, *,
                             layout=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(o, lse)``, o ``[B, H, Sq, D]`` and the natural-log lse
    ``[B, H, Sq]`` float32.  Replaces ``_fwd`` (v1), ``_fwd_v2`` and
    ``_fwd_v3``.  On CUDA the dtype picks the kernel, by an explicit rule
    in the library's entry point: bfloat16 runs the wgmma + TMA kernel,
    float32 the plain-f32 tile kernel, whose products stay exact enough for
    the fp32 path; a failure to build or launch either raises.  ``layout``
    is v1's block-sparse gate, which is not ported."""
    if layout is not None:
        raise NotImplementedError(
            "flash attention with a block-sparse layout: not ported yet — it "
            "comes with the PyTorch port's sparse-attention slice (ROADMAP.md)")
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    b, h, hkv, sq, sk, d = _check_cuda("flash_attention_fwd_cuda", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _lib().ds_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, sq, sk, h // hkv, d, _DTYPE_CODES[q.dtype], int(causal),
        _scale(sm_scale, d), _stream(q.device))
    _raise_on_error("flash_attention_fwd_cuda", err)
    flash_attention_fwd_cuda.launches += 1
    return o, lse


flash_attention_fwd_cuda.launches = 0


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta=None, *, o=None,
                                causal: bool = True,
                                sm_scale: Optional[float] = None):
    """dq: ``(dq, delta)``.  Give either ``delta`` (``rowsum(dO * O)``
    ``[B, H, Sq]`` float32, as the ring callers do) or the forward's ``o``,
    from which the kernel computes delta and returns it for the dkv call.
    Replaces ``_bwd_dq_call`` (v1) and the dq halves of ``_bwd_v2`` and
    ``_bwd_v3``.  On CUDA the dtype picks the kernel (:func:`bwd_route`)."""
    if (delta is None) == (o is None):
        raise ValueError("flash_attention_bwd_dq_cuda: give delta or o")
    if not q.is_cuda:
        if delta is None:
            delta = _delta(o, do)
        return (flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                             sm_scale), delta)
    name = "flash_attention_bwd_dq_cuda"
    b, h, sq = q.shape[:3]
    rows = (b, h, sq)
    extra = (("do", do, None, q.shape), ("lse", lse, torch.float32, rows))
    if o is not None:
        extra += (("o", o, None, q.shape),)
        delta = torch.empty(rows, dtype=torch.float32, device=q.device)
    else:
        extra += (("delta", delta, torch.float32, rows),)
    b, h, hkv, sq, sk, d = _check_cuda(name, q, k, v, *extra)
    dq = torch.empty_like(q)
    err = _lib().ds_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr() if o is not None else None, do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, sq, sk,
        h // hkv, d, _DTYPE_CODES[q.dtype], int(causal), _scale(sm_scale, d),
        _stream(q.device))
    _raise_on_error(name, err)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq, delta


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, *,
                                 causal: bool = True,
                                 sm_scale: Optional[float] = None):
    """(dk, dv) given lse and delta, each summed over the query heads of
    its KV head and written once per key tile.  Replaces ``_bwd_dkv_call``
    (v1) and the dk/dv halves of ``_bwd_v2`` and ``_bwd_v3``.  On CUDA the
    dtype picks the kernel (:func:`bwd_route`)."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             sm_scale)
    name = "flash_attention_bwd_dkv_cuda"
    rows = tuple(q.shape[:3])
    b, h, hkv, sq, sk, d = _check_cuda(
        name, q, k, v, ("do", do, None, q.shape),
        ("lse", lse, torch.float32, rows),
        ("delta", delta, torch.float32, rows))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib().ds_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * hkv, sq, sk, h // hkv, d, _DTYPE_CODES[q.dtype], int(causal),
        _scale(sm_scale, d), _stream(q.device))
    _raise_on_error(name, err)
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0

#: every kernel wrapper of this module, for launch-count bookkeeping
KERNELS = (flash_attention_fwd_cuda, flash_attention_bwd_dq_cuda,
           flash_attention_bwd_dkv_cuda)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Autograd op and public entry
# ---------------------------------------------------------------------------
class _FlashAttention(torch.autograd.Function):
    """The JAX ``_flash_attention_bh`` custom_vjp: the forward kernel saves
    o and lse; the backward runs dq (which computes delta from o) and then
    dkv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd_cuda(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dq, delta = flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o, **kw)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128):
    """Fused attention (``flash_attention.py:1014``).  q: ``[B, H, Sq, D]``;
    k, v: ``[B, Hkv, Sk, D]`` (GQA: ``Hkv | H``).  Returns ``[B, H, Sq, D]``
    in q's dtype, differentiable in q, k and v.

    ``block_q`` / ``block_k`` are the JAX tiling hints; the CUDA kernels use
    their own tiles (in bf16 128 x 128 in the forward, 128 query rows x 64
    keys in dq and 128 keys x 64 query rows in dkv; 64 x 64 in f32) and
    mask ragged edges themselves, and the plain path does not tile, so both
    are accepted and ignored."""
    del block_q, block_k
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, sm_scale)
