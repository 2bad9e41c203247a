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
   Given an int8 pool record (``{"qp", "ps"}``, ``ops/paged_kv.py``) the two
   paged wrappers hand it to their kv8 variants,
   ``paged_decode_attention_kv8_cuda`` and
   ``paged_verify_attention_kv8_cuda``, which fold the per-token scales
   in-kernel.  A wrapper given CUDA tensors launches its kernel and adds one
   to its ``launches`` count, or raises; it takes its plain version only
   for tensors that lie on the CPU.  The three float wrappers pick their
   kernel by dtype (:func:`decode_route`, :func:`verify_route`): bf16 and
   fp16 run the split-K tensor-core kernel (a window of one for decode; a
   contiguous cache read as a pool of one block per row), f32 the f32
   template.
   The kv8 wrappers pick theirs by the query's dtype (:func:`kv8_route`):
   bf16 and fp16 queries run the split-K tensor-core kernel over int8
   codes, f32 queries the f32 template.
 - ``paged_verify_split_plain``: a plain model of the split-K kernels'
   algorithm (per-split partials, then the log-sum-exp merge), on float
   pools and int8 pool records, for the tests and ``chip_smoke.py``; no
   serving path calls it.

The dispatchers ``decode_attention`` and ``paged_decode_attention`` pick
between them by window length, as the JAX dispatchers do on the TPU;
``sliced_window_attention`` runs a window of any width through the verify
kernel, sixteen query positions at a time (the llama family's prefill).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .paged_kv import is_quantized_pool, paged_gather, pool_payload

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: widest window the verify kernel takes; wider windows (long prefill chunks)
#: use the gather-based plain path
VERIFY_T_MAX = 16
#: keys each block of the split-K verify kernel takes (one split)
VERIFY_KEYS_PER_SPLIT = 128
#: query rows per KV head (``rep * T``) the split-K verify kernel takes
VERIFY_SPLIT_MAX_ROWS = 256
#: (b, KV head) pairs one verify call may have: the per-device ticket
#: counters the split-K kernel's merge uses
_TICKET_SLOTS = 1 << 16

#: head dims the library is built for (GPT-2's 64, llama's 128; others come
#: with the model families that need them)
_HEAD_DIMS = (64, 128)
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
    plain path.  An int8 pool record dequantizes to the query dtype, so the
    residual stream keeps the model's compute dtype
    (``decode_attention.py:323-329``).

    q:            [B, H, T, D]
    k/v_pool:     [NB, HKV, block_size, D] shared pool, or its int8 record
    block_tables: int32 [B, NBPER]
    q_pos:        int or int32 [B] — global position of q[:, :, 0]
    """
    k = paged_gather(k_pool, block_tables, out_dtype=q.dtype)
    v = paged_gather(v_pool, block_tables, out_dtype=q.dtype)
    return decode_attention_reference(q, k, v, q_pos, sm_scale=sm_scale)


def verify_splits(nbper: int, block_size: int,
                  keys_per_split: int = VERIFY_KEYS_PER_SPLIT) -> int:
    """Splits of the split-K verify kernel's grid: the table's width in
    keys over the keys a block takes, rounded up.  From shapes alone, so
    the host never waits on the device to learn the rows' lengths."""
    return -(-(nbper * block_size) // keys_per_split)


def verify_route(dtype) -> str:
    """The verify kernel a float pool of ``dtype`` runs: ``"split"`` (the
    split-K tensor-core kernel) for bfloat16 and float16, ``"template"``
    (the f32 template) for float32, whose tensor-core products would round
    to tf32; raises for any other dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return "split"
    if dtype == torch.float32:
        return "template"
    raise ValueError(f"paged verify: dtype {dtype} not supported (float32, "
                     "float16, bfloat16)")


def decode_route(dtype) -> str:
    """The kernel a single-token decode on a float pool or a contiguous
    float cache of ``dtype`` runs: ``"split"`` (the split-K tensor-core
    kernel at T = 1) for bfloat16 and float16, ``"template"`` (the f32
    template) for float32, whose tensor-core products would round to tf32
    and miss the fp32 path's exactness; raises for any other dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return "split"
    if dtype == torch.float32:
        return "template"
    raise ValueError(f"decode attention: dtype {dtype} not supported "
                     "(float32, float16, bfloat16)")


def kv8_route(dtype) -> str:
    """The kernel that queries of ``dtype`` run on an int8 pool, for decode
    and verify alike: ``"split"`` (the split-K tensor-core kernel over int8
    codes) for bfloat16 and float16, ``"template"`` (the f32 template) for
    float32, whose tensor-core products would round to tf32; raises for any
    other dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return "split"
    if dtype == torch.float32:
        return "template"
    raise ValueError(f"kv8 paged attention: query dtype {dtype} not "
                     "supported (float32, float16, bfloat16)")


def _split_operands(pool, block_tables, dtype):
    """A pool's gathered payload ``[B, HKV, S, D]`` in ``dtype`` and, for an
    int8 record, its gathered scales ``[B, HKV, S]`` (else None)."""
    if is_quantized_pool(pool):
        return (paged_gather(pool["qp"], block_tables).to(dtype),
                paged_gather(pool["ps"][..., None], block_tables)[..., 0]
                .to(dtype))
    return paged_gather(pool, block_tables).to(dtype), None


def paged_verify_split_plain(q, k_pool, v_pool, block_tables, q_pos, *,
                             sm_scale: Optional[float] = None,
                             keys_per_split: int = VERIFY_KEYS_PER_SPLIT):
    """The split-K kernels' algorithm in plain PyTorch (float32; float64
    stays float64): each row's keys cut into spans of ``keys_per_split``
    from key 0; per span the masked scores' max ``m_s``, ``l_s = sum exp(s -
    m_s)`` and ``o_s = sum exp(s - m_s) v`` (an empty span: m_s = NEG_INF,
    l_s = 0, o_s = 0); then ``m* = max m_s`` and ``o = sum e^(m_s - m*) o_s
    / sum e^(m_s - m*) l_s``, a zero denominator read as 1.  On int8 pool
    records the codes take the place of K and V and the per-token scales
    fold in as the kv8 kernel folds them: ``ks`` multiplies each score
    column, ``vs`` each probability before its product with V's codes, and
    ``m_s`` and ``l_s`` stay over the unscaled probabilities.  Same
    arguments and result as :func:`paged_decode_attention_reference`
    (whose int8 path dequantizes first)."""
    b, h, t, d = q.shape
    cd = torch.promote_types(q.dtype, torch.float32)
    k, ks = _split_operands(k_pool, block_tables, cd)
    v, vs = _split_operands(v_pool, block_tables, cd)
    hkv, s = k.shape[1], k.shape[2]
    if h != hkv:
        k, v = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
        if ks is not None:
            ks, vs = (x.repeat_interleave(h // hkv, dim=1) for x in (ks, vs))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhtd,bhsd->bhts", q.to(cd), k) * scale
    if ks is not None:
        scores = scores * ks[:, :, None, :]
    nsplit = verify_splits(1, s, keys_per_split)
    n = nsplit * keys_per_split
    base = _row_pos(q_pos, b, q.device).to(torch.int64)
    limit = base[:, None] + torch.arange(t, device=q.device)        # [B, T]
    key = torch.arange(n, device=q.device)
    vis = (key <= limit[:, :, None]) & (key < s)                    # [B, T, n]
    vis = vis[:, None].expand(b, h, t, n)
    scores = torch.nn.functional.pad(scores, (0, n - s))
    v = torch.nn.functional.pad(v, (0, 0, 0, n - s))
    scores = torch.where(vis, scores, NEG_INF).reshape(
        b, h, t, nsplit, keys_per_split)
    vis = vis.reshape(b, h, t, nsplit, keys_per_split)
    m_s = scores.amax(-1)                                          # [B,H,T,n]
    p = torch.where(vis, torch.exp(scores - m_s[..., None]), 0.0)
    l_s = p.sum(-1)
    if vs is not None:
        p = p * torch.nn.functional.pad(vs, (0, n - s)).reshape(
            b, h, 1, nsplit, keys_per_split)
    o_s = torch.einsum("bhtnk,bhnkd->bhtnd", p,
                       v.reshape(b, h, nsplit, keys_per_split, d))
    m_star = m_s.amax(-1, keepdim=True)
    w = torch.exp(m_s - m_star)
    den = (w * l_s).sum(-1)
    o = (w[..., None] * o_s).sum(-2) / torch.where(den == 0, 1.0, den)[..., None]
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
_LIB = None


def _lib():
    """The kernels' library, built at first use (never at import) and typed
    once."""
    global _LIB
    if _LIB is None:
        from .op_builder import builder

        lib = builder("decode_attention", ["decode_attention.cu"]).load()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ds_decode_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            f, p]
        lib.ds_paged_decode_attention.argtypes = [p, p, p, p, p, p, i, i, i,
                                                  i, i, i, i, f, p]
        lib.ds_paged_verify_attention.argtypes = [p, p, p, p, p, p, i, i, i,
                                                  i, i, i, i, i, f, p]
        lib.ds_paged_verify_attention_split.argtypes = [p] * 8 + [i] * 9 + [
            f, p]
        lib.ds_paged_attention_q8_split.argtypes = [p] * 10 + [i] * 9 + [f, p]
        lib.ds_paged_decode_attention_q8.argtypes = [p, p, p, p, p, p, p, p,
                                                     i, i, i, i, i, i, i, f,
                                                     p]
        lib.ds_paged_verify_attention_q8.argtypes = [p, p, p, p, p, p, p, p,
                                                     i, i, i, i, i, i, i, i,
                                                     f, p]
        for fn in (lib.ds_decode_attention, lib.ds_paged_decode_attention,
                   lib.ds_paged_verify_attention,
                   lib.ds_paged_verify_attention_split,
                   lib.ds_paged_attention_q8_split,
                   lib.ds_paged_decode_attention_q8,
                   lib.ds_paged_verify_attention_q8):
            fn.restype = ctypes.c_int
        lib.ds_attention_smem_bytes.argtypes = [i, i]
        lib.ds_attention_smem_bytes.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _row_pos(q_pos, b: int, device) -> torch.Tensor:
    """``q_pos`` as a contiguous int32 ``[B]`` tensor on ``device``; a
    tensor must already live there."""
    if isinstance(q_pos, torch.Tensor):
        if q_pos.device != device:
            raise ValueError(
                f"q_pos is on {q_pos.device}, the queries on {device}")
        if q_pos.dtype == torch.int32 and q_pos.shape == (b,) \
                and q_pos.is_contiguous():
            return q_pos                   # the serving path's positions
        if q_pos.ndim not in (0, 1) or q_pos.numel() not in (1, b):
            raise ValueError(f"q_pos must be a scalar or [{b}], got "
                             f"{tuple(q_pos.shape)}")
        return q_pos.to(torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(q_pos), dtype=torch.int32, device=device)


def _check_cuda(name, q, kv, h, hkv, t, extra=(), kv_dtype=None,
                split=False):
    """Validate what the kernel takes; raises on anything else.  ``kv`` is
    the (k, v) pair of caches or pools, or of int8 codes when ``kv_dtype``
    is ``torch.int8``; ``extra`` names more tensors for the device and
    layout checks; ``split``: the split-K verify kernel, whose limit is
    :data:`VERIFY_SPLIT_MAX_ROWS` query rows per KV head."""
    dev = q.get_device()                   # -1 on the CPU
    for tname, x in (("q", q), ("k", kv[0]), ("v", kv[1])) + tuple(extra):
        if dev < 0 or x.get_device() != dev:
            raise ValueError(f"{name}: {tname} must be a CUDA tensor on "
                             f"{q.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32, float16, bfloat16)")
    kv_dtype = q.dtype if kv_dtype is None else kv_dtype
    if kv[0].dtype != kv_dtype or kv[1].dtype != kv_dtype:
        raise ValueError(f"{name}: k and v must be {kv_dtype}, got "
                         f"{kv[0].dtype} and {kv[1].dtype}")
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: {h} query heads do not group over "
                         f"{hkv} KV heads")
    for tname, x in (("q", q), ("k", kv[0]), ("v", kv[1])):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} is not 16-byte aligned")
    if split:
        if (h // hkv) * t > VERIFY_SPLIT_MAX_ROWS:
            raise ValueError(f"{name}: {h // hkv} heads x {t} tokens per KV "
                             f"head > {VERIFY_SPLIT_MAX_ROWS} query rows")
        return
    smem = _lib().ds_attention_smem_bytes((h // hkv) * t, d)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {h // hkv} heads x {t} tokens per KV head "
                         f"need {smem} bytes of shared memory (> {_SMEM_LIMIT})")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(device) -> int:
    """The handle of the current stream on ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a ``Stream`` object (a few microseconds of every eager
    call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_ROW_TABLES = {}


def _row_tables(b: int, device) -> torch.Tensor:
    """int32 [B, 1] block tables ``[[0], [1], ...]``, made once per (device,
    B): a contiguous cache [B, HKV, S, D] read as a pool of B blocks of S
    keys each."""
    if (device, b) not in _ROW_TABLES:
        _ROW_TABLES[(device, b)] = torch.arange(
            b, dtype=torch.int32, device=device)[:, None].contiguous()
    return _ROW_TABLES[(device, b)]


def decode_attention_cuda(q, k_cache, v_cache, q_pos, *,
                          sm_scale: Optional[float] = None):
    """Single-token decode: q [B, H, 1, D] vs cache [B, HKV, S, D];
    ``q_pos`` scalar or per-row int32 [B].  Replaces
    ``decode_attention_pallas`` (``_decode_kernel``).  On CUDA the dtype
    picks the kernel (:func:`decode_route`) as for the paged decode: bf16
    and fp16 run the split-K tensor-core kernel on the cache read as a pool
    of one S-key block per row, so ``generate`` and the paged server decode
    with the same arithmetic; f32 runs the f32 template."""
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
    if decode_route(q.dtype) == "split":
        # row b's cache [HKV, S, D] is block b of a pool of S-key blocks
        return _paged_cuda(decode_attention_cuda,
                           "ds_paged_verify_attention_split", q, k_cache,
                           v_cache, _row_tables(b, q.device), q_pos, sm_scale)
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


_TICKETS = {}


def _tickets(device) -> torch.Tensor:
    """The split-K verify kernel's int32 ticket counters on ``device``:
    zeroed once, and left at zero by every call (the merging block resets
    its own), so calls and CUDA-graph replays on one stream reuse them."""
    if device not in _TICKETS:
        _TICKETS[device] = torch.zeros(_TICKET_SLOTS, dtype=torch.int32,
                                       device=device)
    return _TICKETS[device]


def _paged_cuda(wrapper, entry, q, k_pool, v_pool, block_tables, q_pos,
                sm_scale):
    """Shared checks + launch of the paged kernels; counts the launch on
    ``wrapper``.  The ``_q8`` entries take int8 pool records, the
    ``_split`` entries scratch and tickets, and every entry but the
    ``decode`` ones the window length."""
    name = wrapper.__name__
    quant = "_q8" in entry
    b, h, t, d = q.shape
    kc, vc = pool_payload(k_pool), pool_payload(v_pool)
    nb, hkv, bs, _ = kc.shape
    if kc.shape != (nb, hkv, bs, d) or vc.shape != kc.shape:
        raise ValueError(f"{name}: pool shapes {tuple(kc.shape)}, "
                         f"{tuple(vc.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block_tables must be int32 [{b}, NBPER], "
                         f"got {block_tables.dtype} {tuple(block_tables.shape)}")
    extra = [("block_tables", block_tables)]
    if quant:
        for tname, sc in (("k scales", k_pool["ps"]), ("v scales",
                                                        v_pool["ps"])):
            if sc.dtype != torch.bfloat16 or sc.shape != (nb, hkv, bs):
                raise ValueError(f"{name}: {tname} must be bfloat16 "
                                 f"{(nb, hkv, bs)}, got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
            extra.append((tname, sc))
    split = entry.endswith("_split")
    _check_cuda(name, q, (kc, vc), h, hkv, t, extra=extra,
                kv_dtype=torch.int8 if quant else None, split=split)
    pos = _row_pos(q_pos, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if quant:
        args = [q.data_ptr(), kc.data_ptr(), k_pool["ps"].data_ptr(),
                vc.data_ptr(), v_pool["ps"].data_ptr()]
    else:
        args = [q.data_ptr(), kc.data_ptr(), vc.data_ptr()]
    args += [block_tables.data_ptr(), pos.data_ptr(), out.data_ptr()]
    nbper = block_tables.shape[1]
    if split:
        if b * hkv > _TICKET_SLOTS:
            raise ValueError(f"{name}: {b} rows x {hkv} KV heads > "
                             f"{_TICKET_SLOTS} ticket counters")
        nsplit = verify_splits(nbper, bs)
        # one split: every row writes its output directly, no partials
        scratch = None if nsplit == 1 else torch.empty(
            b * h * t * nsplit * (d + 2), dtype=torch.float32,
            device=q.device)
        args += [0 if scratch is None else scratch.data_ptr(),
                 _tickets(q.device).data_ptr()]
    args += [b, h, hkv]
    if "decode" not in entry:
        args.append(t)
    args += [bs, nbper]
    if split:
        args.append(nsplit)
    args += [d, _DTYPE_CODES[q.dtype], scale, _stream(q.device)]
    _raise_on_error(name, getattr(_lib(), entry)(*args))
    wrapper.launches += 1
    return out


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, q_pos, *,
                                sm_scale: Optional[float] = None):
    """Single-token paged decode: q [B, H, 1, D] against the pool
    [NB, HKV, bs, D], walking each row's int32 [B, NBPER] block table
    in-kernel.  Replaces ``paged_decode_attention_pallas``; int8 pool
    records go to :func:`paged_decode_attention_kv8_cuda`.  On CUDA the
    dtype picks the kernel (:func:`decode_route`): bf16 and fp16 run the
    split-K tensor-core kernel with a window of one, f32 the f32
    template."""
    if is_quantized_pool(k_pool):
        return paged_decode_attention_kv8_cuda(q, k_pool, v_pool,
                                               block_tables, q_pos,
                                               sm_scale=sm_scale)
    if not q.is_cuda:
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, q_pos, sm_scale=sm_scale)
    if q.shape[2] != 1:
        raise ValueError(f"paged_decode_attention_cuda is single-token, got "
                         f"T={q.shape[2]}")
    entry = {"split": "ds_paged_verify_attention_split",
             "template": "ds_paged_decode_attention"}[decode_route(q.dtype)]
    return _paged_cuda(paged_decode_attention_cuda, entry, q, k_pool, v_pool,
                       block_tables, q_pos, sm_scale)


paged_decode_attention_cuda.launches = 0


def paged_verify_attention_cuda(q, k_pool, v_pool, block_tables, q_pos, *,
                                sm_scale: Optional[float] = None):
    """Paged attention of a T <= :data:`VERIFY_T_MAX` query window per row:
    q [B, H, T, D], row ``i`` of the window at position ``q_pos[b] + i``
    sees keys up to itself.  Replaces ``paged_verify_attention_pallas``;
    int8 pool records go to :func:`paged_verify_attention_kv8_cuda`.  On
    CUDA the dtype picks the kernel (:func:`verify_route`): bf16 and fp16
    run the split-K tensor-core kernel, f32 the f32 template, which keeps
    the fp32 path exact."""
    if is_quantized_pool(k_pool):
        return paged_verify_attention_kv8_cuda(q, k_pool, v_pool,
                                               block_tables, q_pos,
                                               sm_scale=sm_scale)
    if not q.is_cuda:
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, q_pos, sm_scale=sm_scale)
    _check_window(q.shape[2])
    entry = {"split": "ds_paged_verify_attention_split",
             "template": "ds_paged_verify_attention"}[verify_route(q.dtype)]
    return _paged_cuda(paged_verify_attention_cuda, entry, q, k_pool, v_pool,
                       block_tables, q_pos, sm_scale)


paged_verify_attention_cuda.launches = 0


def _check_window(t: int) -> None:
    if not 1 <= t <= VERIFY_T_MAX:
        raise ValueError(f"the paged verify kernels take windows up to "
                         f"{VERIFY_T_MAX}, got T={t}")


def paged_decode_attention_kv8_cuda(q, k_pool, v_pool, block_tables, q_pos,
                                    *, sm_scale: Optional[float] = None):
    """:func:`paged_decode_attention_cuda` on int8 pool records ``{"qp":
    int8 [NB, HKV, bs, D], "ps": bf16 [NB, HKV, bs]}``: the kernel reads
    codes and per-token scales and folds the scales into the score and
    probability columns.  Replaces the ``quant=True`` operands of
    ``_paged_decode_pallas`` (``_paged_pool_operands``).  On CUDA the
    query's dtype picks the kernel (:func:`kv8_route`): bf16 and fp16 run
    the split-K tensor-core kernel, f32 the f32 template."""
    if not q.is_cuda:
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, q_pos, sm_scale=sm_scale)
    if q.shape[2] != 1:
        raise ValueError(f"paged_decode_attention_kv8_cuda is single-token, "
                         f"got T={q.shape[2]}")
    entry = {"split": "ds_paged_attention_q8_split",
             "template": "ds_paged_decode_attention_q8"}[kv8_route(q.dtype)]
    return _paged_cuda(paged_decode_attention_kv8_cuda, entry, q, k_pool,
                       v_pool, block_tables, q_pos, sm_scale)


paged_decode_attention_kv8_cuda.launches = 0


def paged_verify_attention_kv8_cuda(q, k_pool, v_pool, block_tables, q_pos,
                                    *, sm_scale: Optional[float] = None):
    """:func:`paged_verify_attention_cuda` on int8 pool records (as
    :func:`paged_decode_attention_kv8_cuda`, the kernel picked the same
    way).  Replaces the ``quant=True`` operands of
    ``_paged_verify_pallas``."""
    if not q.is_cuda:
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, q_pos, sm_scale=sm_scale)
    _check_window(q.shape[2])
    entry = {"split": "ds_paged_attention_q8_split",
             "template": "ds_paged_verify_attention_q8"}[kv8_route(q.dtype)]
    return _paged_cuda(paged_verify_attention_kv8_cuda, entry, q, k_pool,
                       v_pool, block_tables, q_pos, sm_scale)


paged_verify_attention_kv8_cuda.launches = 0

#: every kernel wrapper of this module, for launch-count bookkeeping
KERNELS = (decode_attention_cuda, paged_decode_attention_cuda,
           paged_verify_attention_cuda, paged_decode_attention_kv8_cuda,
           paged_verify_attention_kv8_cuda)


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


def sliced_window_attention(q, k_cache, v_cache, q_pos, block_tables=None,
                            *, sm_scale: Optional[float] = None):
    """A window of any width T against a paged pool (``block_tables``
    given) or a contiguous cache ``[B, HKV, S, D]`` (``None``: read as a
    pool of one S-key block a row, as B2 reads it), through
    :func:`paged_verify_attention_cuda` on slices of at most
    :data:`VERIFY_T_MAX` query positions, slice ``j`` at base ``q_pos +
    16 j``; the cache holds the whole window already.  A query row's
    result depends only on its own position and keys, so a row gets the
    same arithmetic in a 128-token prefill window as in sixteen-token ones
    (the JAX dispatch sends windows past 16 to the plain path, another
    arithmetic).  On the CPU each slice takes the plain version."""
    if block_tables is None:
        block_tables = _row_tables(q.shape[0], q.device)
    out = [paged_verify_attention_cuda(
        q[:, :, s0:s0 + VERIFY_T_MAX].contiguous(), k_cache, v_cache,
        block_tables, q_pos + s0, sm_scale=sm_scale)
        for s0 in range(0, q.shape[2], VERIFY_T_MAX)]
    return out[0] if len(out) == 1 else torch.cat(out, dim=2)


def paged_decode_attention(q, k_pool, v_pool, block_tables, q_pos, *,
                           sm_scale: Optional[float] = None):
    """Dispatch: the block-table-walking CUDA kernels for single-token
    decode (T == 1) and windows up to :data:`VERIFY_T_MAX`; the gather +
    plain path otherwise (``decode_attention.py:580-603``).  Float pools
    and int8 pool records alike."""
    if q.shape[2] == 1:
        return paged_decode_attention_cuda(q, k_pool, v_pool, block_tables,
                                           q_pos, sm_scale=sm_scale)
    if q.shape[2] <= VERIFY_T_MAX:
        return paged_verify_attention_cuda(q, k_pool, v_pool, block_tables,
                                           q_pos, sm_scale=sm_scale)
    return paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                            q_pos, sm_scale=sm_scale)
