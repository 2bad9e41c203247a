"""Decode attention over a KV cache — the PyTorch port of
``deepspeed_tpu/ops/decode_attention.py``.

Two kinds of function, one API:
 - the plain versions, ``decode_attention_reference`` and
   ``paged_decode_attention_reference``: q of one or more new positions
   against the cache with position-aware causal masking and GQA head
   sharing.  Plain PyTorch; they serve prefill windows wider than
   :data:`VERIFY_T_MAX`, every CPU call, and the tests' comparisons.
 - the kernel wrappers, ``decode_attention_cuda`` (contiguous cache, one
   query token), ``paged_decode_attention_cuda`` (block-paged pool, one
   token) and ``paged_verify_attention_cuda`` (paged, a window of up to 16
   tokens): hand-written CUDA kernels for Hopper
   (``ops/csrc/decode_attention.cu``, loaded through ``ops/op_builder.py``).
   A wrapper given CUDA tensors launches its kernel and adds one to its
   ``launches`` count, or raises; it takes its plain version only for
   tensors that lie on the CPU.

The dispatchers ``decode_attention`` and ``paged_decode_attention`` pick
between them by window length, as the JAX dispatchers do on the TPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .paged_kv import paged_gather

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: widest window the verify kernel takes; wider windows (long prefill chunks)
#: use the gather-based plain path
VERIFY_T_MAX = 16

#: head dims the library is built for (GPT-2's 64; others come with the
#: model families that need them)
_HEAD_DIMS = (64,)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SMEM_LIMIT = 227 * 1024


def decode_attention_reference(q, k_cache, v_cache, q_pos, *,
                               sm_scale: Optional[float] = None):
    """Masked attention of new queries against the KV cache (plain PyTorch).

    q:        [B, H, T, D]  — T new query positions
    k_cache:  [B, HKV, S, D], v_cache: [B, HKV, S, D] — the *already updated*
              cache (new keys written at q_pos .. q_pos+T-1)
    q_pos:    int / 0-d tensor — global position of q[:, :, 0]; or int32 [B]
              per-sequence positions
    """
    b, h, t, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if h != hkv:
        rep = h // hkv
        k_cache = k_cache.repeat_interleave(rep, dim=1)
        v_cache = v_cache.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k_cache).float() * scale
    q_pos = torch.as_tensor(q_pos, device=q.device).to(torch.int64)
    key_idx = torch.arange(s, device=q.device)
    t_idx = torch.arange(t, device=q.device)
    if q_pos.ndim == 0:
        mask = (key_idx[None, :] <= (q_pos + t_idx)[:, None])[None, None]
    else:
        query_idx = q_pos[:, None] + t_idx[None, :]                  # [B, T]
        mask = (key_idx[None, None, :] <= query_idx[:, :, None])[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, v_cache)


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables, q_pos,
                                     *, sm_scale: Optional[float] = None):
    """Gather-based paged attention (plain PyTorch): materialize each row's
    logical cache view through its block table, then run the contiguous
    plain path.

    q:            [B, H, T, D]
    k/v_pool:     [NB, HKV, block_size, D] shared pool
    block_tables: int32 [B, NBPER]
    q_pos:        int or int32 [B] — global position of q[:, :, 0]
    """
    k = paged_gather(k_pool, block_tables)
    v = paged_gather(v_pool, block_tables)
    return decode_attention_reference(q, k, v, q_pos, sm_scale=sm_scale)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _lib():
    """The kernels' library, built at first use (never at import)."""
    from .op_builder import builder

    lib = builder("decode_attention", ["decode_attention.cu"]).load()
    if not getattr(lib, "_ds_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ds_decode_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            f, p]
        lib.ds_paged_decode_attention.argtypes = [p, p, p, p, p, p, i, i, i,
                                                  i, i, i, i, f, p]
        lib.ds_paged_verify_attention.argtypes = [p, p, p, p, p, p, i, i, i,
                                                  i, i, i, i, i, f, p]
        for fn in (lib.ds_decode_attention, lib.ds_paged_decode_attention,
                   lib.ds_paged_verify_attention):
            fn.restype = ctypes.c_int
        lib.ds_attention_smem_bytes.argtypes = [i, i]
        lib.ds_attention_smem_bytes.restype = ctypes.c_size_t
        lib._ds_typed = True
    return lib


def _row_pos(q_pos, b: int, device) -> torch.Tensor:
    """``q_pos`` as a contiguous int32 ``[B]`` tensor on ``device``; a
    tensor must already live there."""
    if isinstance(q_pos, torch.Tensor):
        if q_pos.device != device:
            raise ValueError(
                f"q_pos is on {q_pos.device}, the queries on {device}")
        if q_pos.ndim not in (0, 1) or q_pos.numel() not in (1, b):
            raise ValueError(f"q_pos must be a scalar or [{b}], got "
                             f"{tuple(q_pos.shape)}")
        return q_pos.to(torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(q_pos), dtype=torch.int32, device=device)


def _check_cuda(name, q, kv, h, hkv, t, extra=()):
    """Validate what the kernel takes; raises on anything else."""
    for tname, x in (("q", q), ("k", kv[0]), ("v", kv[1])) + tuple(extra):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name}: {tname} must be a CUDA tensor on "
                             f"{q.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32, float16, bfloat16)")
    if kv[0].dtype != q.dtype or kv[1].dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must share one dtype")
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: {h} query heads do not group over "
                         f"{hkv} KV heads")
    for tname, x in (("q", q), ("k", kv[0]), ("v", kv[1])):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} is not 16-byte aligned")
    smem = _lib().ds_attention_smem_bytes((h // hkv) * t, d)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {h // hkv} heads x {t} tokens per KV head "
                         f"need {smem} bytes of shared memory (> {_SMEM_LIMIT})")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decode_attention_cuda(q, k_cache, v_cache, q_pos, *,
                          sm_scale: Optional[float] = None):
    """Single-token decode: q [B, H, 1, D] vs cache [B, HKV, S, D];
    ``q_pos`` scalar or per-row int32 [B].  Replaces
    ``decode_attention_pallas`` (``_decode_kernel``)."""
    if not q.is_cuda:
        return decode_attention_reference(q, k_cache, v_cache, q_pos,
                                          sm_scale=sm_scale)
    b, h, t, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if t != 1:
        raise ValueError(f"decode_attention_cuda is single-token, got T={t}")
    if k_cache.shape != (b, hkv, s, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention_cuda: cache shapes "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)} do "
                         f"not match q {tuple(q.shape)}")
    _check_cuda("decode_attention_cuda", q, (k_cache, v_cache), h, hkv, 1)
    pos = _row_pos(q_pos, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    err = _lib().ds_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, h, hkv, s, d, _DTYPE_CODES[q.dtype], scale,
        _stream(q.device))
    _raise_on_error("decode_attention_cuda", err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def _paged_cuda(wrapper, entry, q, k_pool, v_pool, block_tables, q_pos,
                sm_scale):
    """Shared checks + launch of the two paged kernels; counts the launch
    on ``wrapper``."""
    name = wrapper.__name__
    b, h, t, d = q.shape
    nb, hkv, bs, _ = k_pool.shape
    if k_pool.shape != (nb, hkv, bs, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block_tables must be int32 [{b}, NBPER], "
                         f"got {block_tables.dtype} {tuple(block_tables.shape)}")
    _check_cuda(name, q, (k_pool, v_pool), h, hkv, t,
                extra=(("block_tables", block_tables),))
    pos = _row_pos(q_pos, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    args = [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, hkv]
    if entry == "ds_paged_verify_attention":
        args.append(t)
    args += [bs, block_tables.shape[1], d, _DTYPE_CODES[q.dtype], scale,
             _stream(q.device)]
    _raise_on_error(name, getattr(_lib(), entry)(*args))
    wrapper.launches += 1
    return out


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, q_pos, *,
                                sm_scale: Optional[float] = None):
    """Single-token paged decode: q [B, H, 1, D] against the pool
    [NB, HKV, bs, D], walking each row's int32 [B, NBPER] block table
    in-kernel.  Replaces ``paged_decode_attention_pallas``."""
    if not q.is_cuda:
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, q_pos, sm_scale=sm_scale)
    if q.shape[2] != 1:
        raise ValueError(f"paged_decode_attention_cuda is single-token, got "
                         f"T={q.shape[2]}")
    return _paged_cuda(paged_decode_attention_cuda,
                       "ds_paged_decode_attention", q, k_pool, v_pool,
                       block_tables, q_pos, sm_scale)


paged_decode_attention_cuda.launches = 0


def paged_verify_attention_cuda(q, k_pool, v_pool, block_tables, q_pos, *,
                                sm_scale: Optional[float] = None):
    """Paged attention of a T <= :data:`VERIFY_T_MAX` query window per row:
    q [B, H, T, D], row ``i`` of the window at position ``q_pos[b] + i``
    sees keys up to itself.  Replaces ``paged_verify_attention_pallas``."""
    if not q.is_cuda:
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, q_pos, sm_scale=sm_scale)
    t = q.shape[2]
    if not 1 <= t <= VERIFY_T_MAX:
        raise ValueError(f"paged_verify_attention_cuda takes windows up to "
                         f"{VERIFY_T_MAX}, got T={t}")
    return _paged_cuda(paged_verify_attention_cuda,
                       "ds_paged_verify_attention", q, k_pool, v_pool,
                       block_tables, q_pos, sm_scale)


paged_verify_attention_cuda.launches = 0

#: every kernel wrapper of this module, for launch-count bookkeeping
KERNELS = (decode_attention_cuda, paged_decode_attention_cuda,
           paged_verify_attention_cuda)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def decode_attention(q, k_cache, v_cache, q_pos, *,
                     sm_scale: Optional[float] = None):
    """Dispatch: the CUDA kernel for single-token decode, the plain path
    for wider windows (``decode_attention.py:244-251``)."""
    if q.shape[2] == 1:
        return decode_attention_cuda(q, k_cache, v_cache, q_pos,
                                     sm_scale=sm_scale)
    return decode_attention_reference(q, k_cache, v_cache, q_pos,
                                      sm_scale=sm_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, q_pos, *,
                           sm_scale: Optional[float] = None):
    """Dispatch: the block-table-walking CUDA kernels for single-token
    decode (T == 1) and windows up to :data:`VERIFY_T_MAX`; the gather +
    plain path otherwise (``decode_attention.py:580-603``)."""
    if q.shape[2] == 1:
        return paged_decode_attention_cuda(q, k_pool, v_pool, block_tables,
                                           q_pos, sm_scale=sm_scale)
    if q.shape[2] <= VERIFY_T_MAX:
        return paged_verify_attention_cuda(q, k_pool, v_pool, block_tables,
                                           q_pos, sm_scale=sm_scale)
    return paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                            q_pos, sm_scale=sm_scale)
