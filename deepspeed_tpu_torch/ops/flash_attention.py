"""Flash attention, forward and backward — the PyTorch port of
``deepspeed_tpu/ops/flash_attention.py``.

Layout as in the JAX package: q ``[B, H, Sq, D]``, k and v
``[B, Hkv, Sk, D]`` with ``Hkv | H`` (GQA: query head ``h`` reads KV head
``h // (H // Hkv)``, the JAX ``head_rep``); the causal mask is top-left
aligned (key ``<=`` query row, as ``tril(ones(Sq, Sk))``); the row
log-sum-exp is natural-log ``[B, H, Sq]`` float32, the format of the JAX
``_fwd`` (v1).

Block-sparse attention (``ops/sparse_attention``) passes a ``layout``
``[1 or H, S/block, S/block]`` of 0/1 and its ``block`` to every function
below: a (query row, key) pair is then visible only where
``layout[h, row // block, col // block]`` is set (h the query head), on top
of the causal mask, and a query row that sees no key gets o = 0 and
lse = -inf, as the JAX kernels' layout gate gives it.

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
   choice): bf16 and fp16 run the Hopper kernels (wgmma products, TMA
   loads, register-resident score and gradient tiles; one template, the
   element type its parameter), float32 plain-f32 tile kernels (the
   tensor cores would round f32 to tf32).  The forward kernels and the
   dq/dkv pair compute what the JAX package's seven
   ``pallas_call`` sites compute (v1, v2 and v3 differ only in how they fit
   the TPU's VMEM).  The three wrappers are also the ring-attention
   building blocks (``parallel/sequence.py`` calls ``_fwd``,
   ``_bwd_dq_call`` and ``_bwd_dkv_call``): a forward that returns the lse,
   and dq and dkv calls that take a given lse and delta.
 - ``flash_attention``, the JAX entry point's signature over
   ``_FlashAttention`` (a ``torch.autograd.Function`` whose forward is the
   registered op :data:`flash_fwd_op` and whose backward runs the dq and
   dkv wrappers).
"""

from __future__ import annotations

import ctypes
import math
import weakref
from collections import OrderedDict
from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: head dims the library is built for: GPT-2's 64 and Llama's 128; the
#: gated (``layout=``) kernels take 64 only
_HEAD_DIMS = (64, 128)
_LAYOUT_HEAD_DIMS = (64,)
#: dtype codes of the library; the gated kernels take float32 and bfloat16
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_LAYOUT_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _scale(sm_scale, d) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


def _compute_dtype(x):
    """float32 for float32/bfloat16/float16 inputs; float64 stays
    float64."""
    return torch.promote_types(x.dtype, torch.float32)


def _expand_kv(q, kv):
    """KV heads repeated to the query heads (GQA), in the compute dtype."""
    rep = q.shape[1] // kv.shape[1]
    kv = kv.to(_compute_dtype(q))
    return kv.repeat_interleave(rep, dim=1) if rep > 1 else kv


def _visible(sq, sk, causal, device, layout=None, block=None, heads=1):
    """The visibility mask, or None when every key is visible: [Sq, Sk]
    bool, or with a layout [heads, Sq, Sk] (``layout[h, row // block,
    col // block] != 0`` and the causal mask; a one-head layout is
    broadcast to ``heads``)."""
    mask = None
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=device).tril()
    if layout is None:
        return mask
    lay = layout.to(device) != 0
    lay = lay[:, torch.arange(sq, device=device) // block]
    lay = lay[:, :, torch.arange(sk, device=device) // block]
    lay = lay.expand(heads, sq, sk)
    return lay if mask is None else lay & mask


def _scores(q, k, causal, sm_scale, layout=None, block=None):
    """Scaled scores ``q k^T`` [B, H, Sq, Sk] in the compute dtype, masked
    entries at ``DEFAULT_MASK_VALUE``; and the mask."""
    cd = _compute_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(cd), _expand_kv(q, k))
    s = s * _scale(sm_scale, q.shape[-1])
    mask = _visible(q.shape[2], k.shape[2], causal, q.device, layout, block,
                    q.shape[1])
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
                              sm_scale: Optional[float] = None, *,
                              layout=None, block: Optional[int] = None):
    """``(o, lse)``: o ``[B, H, Sq, D]`` in q's dtype and the natural-log
    row log-sum-exp ``[B, H, Sq]`` of the scaled, masked scores.  With a
    layout, a row that sees no key gets o = 0 and lse = -inf."""
    s, mask = _scores(q, k, causal, sm_scale, layout, block)
    if layout is None:
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
    else:
        lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, _expand_kv(q, v))
    return o.to(q.dtype), lse


def _probs(q, k, lse, causal, sm_scale, layout=None, block=None):
    """Softmax probabilities rebuilt from the lse, zero where masked
    (selected, not multiplied: a row that sees no key has lse = -inf)."""
    s, mask = _scores(q, k, causal, sm_scale, layout, block)
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    return p if mask is None else torch.where(mask, p, 0.0)


def _dscores(q, k, v, do, lse, delta, causal, sm_scale, layout=None,
             block=None):
    """(p, ds) with ds = p * (dO v^T - delta), both [B, H, Sq, Sk]."""
    p = _probs(q, k, lse, causal, sm_scale, layout, block)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(p.dtype), _expand_kv(q, v))
    return p, p * (dp - delta.to(p.dtype)[..., None])


def _sum_groups(x, hkv):
    """[B, H, S, D] summed over the ``H // hkv`` query heads of each KV
    head -> [B, hkv, S, D]."""
    b, h, s, d = x.shape
    return x.reshape(b, hkv, h // hkv, s, d).sum(2)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                                 sm_scale: Optional[float] = None, *,
                                 layout=None, block: Optional[int] = None):
    """dq given the forward's lse and ``delta = rowsum(dO * O)``."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, sm_scale, layout, block)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _expand_kv(q, k))
    return (dq * _scale(sm_scale, q.shape[-1])).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                                  sm_scale: Optional[float] = None, *,
                                  layout=None, block: Optional[int] = None):
    """(dk, dv) given lse and delta, summed over each KV head's query
    heads."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, sm_scale, layout, block)
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
                                       sm_scale: Optional[float] = None, *,
                                       layout=None,
                                       block: Optional[int] = None):
    """``wgmma_dq_kernel``'s algorithm in plain PyTorch (float32; float64
    stays float64): the keys cut into tiles of ``BWD_TILE`` from key 0;
    per tile S = q k^T and dP = dO v^T, P = exp2(S sm_scale log2(e) - lse
    log2(e)) (zero where masked), dS = P (dP - delta) rounded to q's dtype,
    and dq += dS k summed over the tiles in key order; then dq * sm_scale
    rounded to q's dtype.  With a layout the gated kernel skips tiles that
    hold no visible pair; they add exact zeros here."""
    cd = _compute_dtype(q)
    scale = _scale(sm_scale, q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    qc, doc = q.to(cd), do.to(cd)
    kc, vc = _expand_kv(q, k), _expand_kv(q, v)
    lse2 = (lse.to(cd) * math.log2(math.e))[..., None]
    dl = delta.to(cd)[..., None]
    mask = _visible(sq, sk, causal, q.device, layout, block, q.shape[1])
    dq = torch.zeros(qc.shape, dtype=cd, device=q.device)
    for k0 in range(0, sk, BWD_TILE):
        kt, vt = kc[:, :, k0:k0 + BWD_TILE], vc[:, :, k0:k0 + BWD_TILE]
        s = torch.matmul(qc, kt.transpose(-1, -2))
        dp = torch.matmul(doc, vt.transpose(-1, -2))
        p = torch.exp2(s * (scale * math.log2(math.e)) - lse2)
        if mask is not None:
            p = torch.where(mask[..., k0:k0 + BWD_TILE], p, 0.0)
        ds = (p * (dp - dl)).to(q.dtype).to(cd)
        dq = dq + torch.matmul(ds, kt)
    return (dq * scale).to(q.dtype)


def flash_attention_bwd_dkv_tiled_plain(q, k, v, do, lse, delta,
                                        causal: bool = True,
                                        sm_scale: Optional[float] = None, *,
                                        layout=None,
                                        block: Optional[int] = None):
    """``wgmma_dkv_kernel``'s algorithm in plain PyTorch (float32; float64
    stays float64), on the transposed problem: for each KV head, its rep
    query heads in order and each head's queries in tiles of ``BWD_TILE``
    from row 0, S^T = k q^T and dP^T = v dO^T, P^T =
    exp2(S^T sm_scale log2(e) - lse log2(e)) taken by column (zero where
    masked), dS^T = P^T (dP^T - delta); P^T and dS^T rounded to q's dtype,
    dv += P^T dO and dk += dS^T q summed in that order; then dk * sm_scale
    and dv rounded to k's dtype.  Key rows are independent, so the
    kernel's 128-key tiles need no loop here; a query tile that lies
    wholly above a key's diagonal, or outside the layout, adds zeros, as
    the kernel's skipped tiles do (query head ``kvh * rep + g`` under its
    own layout head)."""
    cd = _compute_dtype(q)
    scale = _scale(sm_scale, q.shape[-1])
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    kc, vc = k.to(cd), v.to(cd)
    log2e = math.log2(math.e)
    # [Sk, Sq], or [hkv, rep, Sk, Sq] per query head
    mask = _visible(sq, sk, causal, q.device, layout, block, h)
    if mask is not None:
        mask = mask.transpose(-1, -2)
        if mask.ndim == 3:
            mask = mask.reshape(hkv, rep, sk, sq)
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
            if mask is not None:
                pt = torch.where(mask[:, g, :, rows] if mask.ndim == 4
                                 else mask[:, rows], pt, 0.0)
            dst = pt * (dpt - dh[:, :, None, rows])
            dv = dv + torch.matmul(pt.to(q.dtype).to(cd), do_t)
            dk = dk + torch.matmul(dst.to(q.dtype).to(cd), qt)
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """rowsum(dO * O) in the compute dtype, [B, H, Sq]."""
    cd = _compute_dtype(o)
    return (do.to(cd) * o.to(cd)).sum(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              sm_scale: Optional[float] = None, *,
                              layout=None, block: Optional[int] = None):
    """The recompute backward: (dq, dk, dv) from the forward's o and lse."""
    delta = _delta(o, do)
    kw = dict(layout=layout, block=block)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                      sm_scale, **kw)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                           sm_scale, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Block-sparse layouts: checks and the kernels' tile maps
# ---------------------------------------------------------------------------
#: (query rows, keys) a tile of each gated kernel: bf16 wgmma_fwd_kernel,
#: wgmma_dq_kernel and wgmma_dkv_kernel; f32 fwd_kernel, dq_kernel and
#: dkv_kernel.  dkv walks a key tile's column of query tiles.
TILES = {("fwd", torch.bfloat16): (128, 128),
         ("dq", torch.bfloat16): (128, 64),
         ("dkv", torch.bfloat16): (64, 128),
         ("fwd", torch.float32): (64, 64),
         ("dq", torch.float32): (64, 64),
         ("dkv", torch.float32): (64, 64)}
#: bit 30 of a tile map entry: every element of the tile is visible
FULL = 1 << 30
#: bit 29: under causal, some key of the tile lies after some query of it
DIAG = 1 << 29
#: layout sub-blocks a tile may span along either axis (64-bit masks)
MAX_SUB = 8


def _check_layout(name, q, k, layout, block):
    """Raises unless the layout passes the checks every device makes: an
    integer or bool tensor ``[1 or H, S/block, S/block]`` on q's device,
    ``block`` a positive divisor of S = Sq = Sk.  On CUDA ``block`` must
    also be a power of two of at least 16 (DeepSpeed's block-sparse
    kernels take 16, 32, 64 and 128), so that a tile spans at most 8
    layout blocks a side and each block lies on whole tiles or is one."""
    h, sq, sk = q.shape[1], q.shape[2], k.shape[2]
    if not isinstance(layout, torch.Tensor) or layout.dtype.is_floating_point \
            or layout.dtype.is_complex:
        got = getattr(layout, "dtype", type(layout))
        raise ValueError(f"{name}: the layout must be an integer or bool "
                         f"tensor, got {got}")
    if not isinstance(block, int) or block < 1 or sq != sk or sq % block:
        raise ValueError(f"{name}: a layout needs Sq == Sk and a block that "
                         f"divides them (Sq={sq}, Sk={sk}, block={block})")
    n = sq // block
    if layout.ndim != 3 or layout.shape[0] not in (1, h) or \
            tuple(layout.shape[1:]) != (n, n):
        raise ValueError(f"{name}: layout {tuple(layout.shape)}, expected "
                         f"[1 or {h}, {n}, {n}]")
    if layout.device != q.device:
        raise ValueError(f"{name}: the layout lies on {layout.device}, q on "
                         f"{q.device}")
    if q.is_cuda and (block < 16 or block & (block - 1)):
        raise ValueError(f"{name}: the CUDA kernels take a layout block that "
                         f"is a power of two >= 16, got {block}")


class TileMap:
    """A layout's live tiles for one kernel's tile shape, as CSR on the
    layout's device.  ``offsets`` int32 ``[rows + 1]``; ``entries`` int32
    (tile index, ``| FULL`` when every element of the tile is visible,
    ``| DIAG`` when, under causal, some key of the tile lies after some
    query of it);
    ``masks`` int64, the tile's layout sub-blocks that hold a visible pair
    (bit ``8 * local query block + local key block``, blocks of ``block``
    elements counted from the tile's first; one block when it covers the
    tile).  A row map (``by_key=False``) has a row per (query head, query
    tile) listing key tiles in key order; a column map (dkv's) has a row
    per (KV head, key tile) listing ``g * n_query_tiles + query tile`` for
    the query heads ``kvh * rep + g`` in that order.  ``order`` int32
    ``[rows]``: the rows by falling length (ties in row order), the order
    in which the wgmma kernels launch their blocks, so that the longest
    lists (a global row, the last causal rows) start first."""

    def __init__(self, offsets, entries, masks, order, live):
        self.offsets, self.entries, self.masks = offsets, entries, masks
        self.order = order
        self.live = live                           # live tiles


def _tile_bits(layout, block, s, tq, tk, causal):
    """(masks, flags) ``[H, nq, nk]``: each tile's sub-block bits (layout
    blocks with a visible pair in the tile) and its FULL and DIAG flags."""
    dev = layout.device
    lay = layout != 0
    nb = lay.shape[1]
    nq, nk = -(-s // tq), -(-s // tk)

    def spans(n, t):
        """Layout block of (tile, local block), and that part's element
        range clipped to the tile and the sequence."""
        sub = max(1, t // block)
        start = torch.arange(n, device=dev)[:, None] * t
        blk = start // block + torch.arange(sub, device=dev)[None]
        lo = torch.maximum(blk * block, start)
        hi = torch.minimum(torch.minimum((blk + 1) * block, start + t),
                           torch.tensor(s, device=dev))
        return blk.clamp(max=nb - 1), lo, hi, sub

    qb, r_lo, r_hi, sub_q = spans(nq, tq)
    kb, c_lo, c_hi, sub_k = spans(nk, tk)
    on = lay[:, qb][:, :, :, kb]                   # [H, nq, sub_q, nk, sub_k]
    vis = on & ((r_lo < r_hi)[:, :, None, None] & (c_lo < c_hi)[None, None])
    if causal:                                     # some key <= some query
        vis &= c_lo[None, None] <= (r_hi - 1)[:, :, None, None]
    # 1 << (8 i + j): bit 63 wraps to the sign bit, and the sum of distinct
    # powers of two is their OR
    shifts = MAX_SUB * torch.arange(sub_q, device=dev)[:, None] + \
        torch.arange(sub_k, device=dev)[None]
    weights = torch.ones_like(shifts) << shifts
    masks = (vis.permute(0, 1, 3, 2, 4).long() * weights).sum((-1, -2))
    qt, kt = torch.arange(nq, device=dev), torch.arange(nk, device=dev)
    full = on.all(4).all(2) & (((qt + 1) * tq <= s)[:, None] &
                               ((kt + 1) * tk <= s)[None])
    diag = torch.zeros_like(full)
    if causal:
        diag = (kt * tk + tk - 1)[None] > (qt * tq)[:, None]
        full &= ~diag
    return masks, full.long() * FULL | diag.long() * DIAG


def layout_tile_map(layout, block: int, seq: int, tile_q: int, tile_k: int,
                    causal: bool, kv_heads: Optional[int] = None) -> TileMap:
    """The :class:`TileMap` of ``layout`` (``[H, S/block, S/block]``, query
    heads) for tiles of ``tile_q`` query rows x ``tile_k`` keys over a
    sequence of ``seq``: a row map, or with ``kv_heads`` dkv's column map.
    Built with tensor operations on the layout's device."""
    sub = max(1, tile_q // block), max(1, tile_k // block)
    if max(sub) > MAX_SUB or (block < max(tile_q, tile_k) and
                              max(tile_q, tile_k) % block):
        raise ValueError(f"layout block {block} does not tile {tile_q} x "
                         f"{tile_k} into at most {MAX_SUB} x {MAX_SUB} "
                         "whole blocks")
    masks, flags = _tile_bits(layout, block, seq, tile_q, tile_k, causal)
    h, nq, nk = masks.shape
    live = masks != 0
    if kv_heads is None:
        idx = live.nonzero()[:, 2]
        rows = live.sum(-1).flatten()
    else:
        rep = h // kv_heads
        def order(x):
            return x.reshape(kv_heads, rep, nq, nk).permute(0, 3, 1, 2)

        live, masks, flags = order(live), order(masks), order(flags)
        g_i = live.nonzero()
        idx = g_i[:, 2] * nq + g_i[:, 3]
        rows = live.sum((-1, -2)).flatten()
    offsets = torch.zeros(rows.numel() + 1, dtype=torch.int32,
                          device=layout.device)
    offsets[1:] = rows.cumsum(0)
    entries = (idx | flags[live]).to(torch.int32)
    order = torch.sort(rows, descending=True, stable=True).indices
    return TileMap(offsets, entries, masks[live].contiguous(),
                   order.to(torch.int32), int(idx.numel()))


#: tile maps of live layouts: id(layout) -> (weakref, version, {key: map})
_TILE_MAPS: "OrderedDict[int, tuple]" = OrderedDict()


def _kernel_tile_map(kernel, dtype, layout, block, seq, causal, heads,
                     kv_heads):
    """The tile map ``kernel`` (fwd, dq or dkv) launched on ``dtype`` needs
    for ``heads`` query heads over ``kv_heads`` KV heads, built once per
    (layout, shape): cached by the layout tensor's identity and version, so
    a layout edited in place is mapped again."""
    key = (kernel, dtype, block, seq, bool(causal), heads, kv_heads)
    hit = _TILE_MAPS.get(id(layout))
    if hit is None or hit[0]() is not layout or hit[1] != layout._version:
        hit = (weakref.ref(layout), layout._version, {})
        _TILE_MAPS[id(layout)] = hit
        while len(_TILE_MAPS) > 8:
            _TILE_MAPS.popitem(last=False)
    maps = hit[2]
    if key not in maps:
        tq, tk = TILES[(kernel, dtype)]
        n = layout.shape[1]
        maps[key] = layout_tile_map(layout.expand(heads, n, n), block, seq,
                                    tq, tk, causal,
                                    kv_heads if kernel == "dkv" else None)
    return maps[key]


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
        # the gated kernels: the tile map (offsets, entries, masks, order),
        # its head count and log2 of the layout's block before the stream
        gate = [p, p, p, p, i, i, p]
        lib.ds_flash_attention_fwd_layout.argtypes = \
            [p] * 5 + [i] * 7 + [f] + gate
        lib.ds_flash_attention_bwd_dq_layout.argtypes = \
            [p] * 8 + [i] * 7 + [f] + gate
        lib.ds_flash_attention_bwd_dkv_layout.argtypes = \
            [p] * 8 + [i] * 7 + [f] + gate
        for fn in (lib.ds_flash_attention_fwd, lib.ds_flash_attention_bwd_dq,
                   lib.ds_flash_attention_bwd_dkv,
                   lib.ds_flash_attention_fwd_layout,
                   lib.ds_flash_attention_bwd_dq_layout,
                   lib.ds_flash_attention_bwd_dkv_layout):
            fn.restype = ctypes.c_int
        lib._ds_typed = True
    return lib


def bwd_route(dtype) -> str:
    """The backward kernels inputs of ``dtype`` run, by the rule of the
    library's entry points: ``"wgmma"`` (``wgmma_dq_kernel`` and
    ``wgmma_dkv_kernel``: wgmma products, TMA loads, register-resident
    tiles) for bfloat16 and float16, ``"tile"`` (``dq_kernel`` and
    ``dkv_kernel``, plain f32 products) for float32, whose tensor-core
    products would round to tf32; raises for any other dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma"
    if dtype == torch.float32:
        return "tile"
    raise ValueError(f"flash attention backward: dtype {dtype} not supported "
                     "(float32, bfloat16, float16)")


def check_head_dim(name: str, d: int, gated: bool = False) -> None:
    """Raises unless the kernels are built for head dim ``d``: 64 or 128,
    and with a layout (``gated``) 64 only."""
    if gated and d in _HEAD_DIMS and d not in _LAYOUT_HEAD_DIMS:
        raise ValueError(
            f"{name}: the layout gate runs at head dim {_LAYOUT_HEAD_DIMS}, "
            f"not {d} (ROADMAP.md Queue B 'still to port': the layout gate "
            "at head dim 128)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")


def _check_cuda(name, q, k, v, *rest, gated=False):
    """Validate what the kernels take; raises on anything else.  ``rest``:
    (label, tensor, dtype or None for q's dtype, shape); ``gated``: a
    layout call."""
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
                         "bfloat16, float16)")
    if gated and q.dtype not in _LAYOUT_DTYPES:
        raise ValueError(f"{name}: the layout gate runs in float32 and "
                         f"bfloat16, not {q.dtype} (no model path runs a "
                         "float16 layout)")
    check_head_dim(name, d, gated)
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


def _gate_args(kernel, q, layout, block, causal, hkv):
    """The gated entry points' tile-map arguments for ``kernel``."""
    h, seq = q.shape[1], q.shape[2]
    tm = _kernel_tile_map(kernel, q.dtype, layout, block, seq, causal, h,
                          hkv)
    return (tm.offsets.data_ptr(), tm.entries.data_ptr(), tm.masks.data_ptr(),
            tm.order.data_ptr(), hkv if kernel == "dkv" else h,
            block.bit_length() - 1)


def flash_attention_fwd_cuda(q, k, v, causal: bool = True,
                             sm_scale: Optional[float] = None, *,
                             layout=None, block: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(o, lse)``, o ``[B, H, Sq, D]`` and the natural-log lse
    ``[B, H, Sq]`` float32.  Replaces ``_fwd`` (v1), ``_fwd_v2`` and
    ``_fwd_v3``.  On CUDA the dtype picks the kernel, by an explicit rule
    in the library's entry point: bfloat16 and float16 run the wgmma + TMA
    kernel,
    float32 the plain-f32 tile kernel, whose products stay exact enough for
    the fp32 path; a failure to build or launch either raises.  With a
    ``layout`` (v1's block-sparse gate, ``_fwd_kernel`` :63-68) the same
    kernels run gated over the layout's live tiles and count in
    ``layout_launches``."""
    if layout is not None:
        return _fwd_gated(q, k, v, causal, sm_scale, layout, block)
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


def _fwd_gated(q, k, v, causal, sm_scale, layout, block):
    name = "flash_attention_fwd_cuda"
    _check_layout(name, q, k, layout, block)
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale,
                                         layout=layout, block=block)
    b, h, hkv, sq, sk, d = _check_cuda(name, q, k, v, gated=True)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _lib().ds_flash_attention_fwd_layout(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, sq, sk, h // hkv, d, _DTYPE_CODES[q.dtype], int(causal),
        _scale(sm_scale, d), *_gate_args("fwd", q, layout, block, causal, hkv),
        _stream(q.device))
    _raise_on_error(name, err)
    flash_attention_fwd_cuda.layout_launches += 1
    return o, lse


flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_cuda.layout_launches = 0


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta=None, *, o=None,
                                causal: bool = True,
                                sm_scale: Optional[float] = None, layout=None,
                                block: Optional[int] = None):
    """dq: ``(dq, delta)``.  Give either ``delta`` (``rowsum(dO * O)``
    ``[B, H, Sq]`` float32, as the ring callers do) or the forward's ``o``,
    from which the kernel computes delta and returns it for the dkv call.
    Replaces ``_bwd_dq_call`` (v1) and the dq halves of ``_bwd_v2`` and
    ``_bwd_v3``.  On CUDA the dtype picks the kernel (:func:`bwd_route`);
    with a ``layout`` it runs gated (``_bwd_dq_kernel`` :183-188) and
    counts in ``layout_launches``."""
    if (delta is None) == (o is None):
        raise ValueError("flash_attention_bwd_dq_cuda: give delta or o")
    if layout is not None:
        return _dq_gated(q, k, v, do, lse, delta, o, causal, sm_scale, layout,
                         block)
    if not q.is_cuda:
        if delta is None:
            delta = _delta(o, do)
        return (flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                             sm_scale), delta)
    name = "flash_attention_bwd_dq_cuda"
    b, h, hkv, sq, sk, d, delta = _dq_checked(name, q, k, v, do, lse, delta, o)
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


def _dq_checked(name, q, k, v, do, lse, delta, o, gated=False):
    """dq's checks; with ``o`` given, the delta it will write."""
    b, h, sq = q.shape[:3]
    rows = (b, h, sq)
    extra = (("do", do, None, q.shape), ("lse", lse, torch.float32, rows))
    if o is not None:
        extra += (("o", o, None, q.shape),)
        delta = torch.empty(rows, dtype=torch.float32, device=q.device)
    else:
        extra += (("delta", delta, torch.float32, rows),)
    return _check_cuda(name, q, k, v, *extra, gated=gated) + (delta,)


def _dq_gated(q, k, v, do, lse, delta, o, causal, sm_scale, layout, block):
    name = "flash_attention_bwd_dq_cuda"
    _check_layout(name, q, k, layout, block)
    if not q.is_cuda:
        if delta is None:
            delta = _delta(o, do)
        return (flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                             sm_scale, layout=layout,
                                             block=block), delta)
    b, h, hkv, sq, sk, d, delta = _dq_checked(name, q, k, v, do, lse, delta, o,
                                              gated=True)
    dq = torch.empty_like(q)
    err = _lib().ds_flash_attention_bwd_dq_layout(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr() if o is not None else None, do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, sq, sk,
        h // hkv, d, _DTYPE_CODES[q.dtype], int(causal), _scale(sm_scale, d),
        *_gate_args("dq", q, layout, block, causal, hkv), _stream(q.device))
    _raise_on_error(name, err)
    flash_attention_bwd_dq_cuda.layout_launches += 1
    return dq, delta


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dq_cuda.layout_launches = 0


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, *,
                                 causal: bool = True,
                                 sm_scale: Optional[float] = None, layout=None,
                                 block: Optional[int] = None):
    """(dk, dv) given lse and delta, each summed over the query heads of
    its KV head and written once per key tile.  Replaces ``_bwd_dkv_call``
    (v1) and the dk/dv halves of ``_bwd_v2`` and ``_bwd_v3``.  On CUDA the
    dtype picks the kernel (:func:`bwd_route`); with a ``layout`` it runs
    gated (``_bwd_dkv_kernel`` :244-249, each query head under its own
    layout head) and counts in ``layout_launches``."""
    if layout is not None:
        return _dkv_gated(q, k, v, do, lse, delta, causal, sm_scale, layout,
                          block)
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


def _dkv_gated(q, k, v, do, lse, delta, causal, sm_scale, layout, block):
    name = "flash_attention_bwd_dkv_cuda"
    _check_layout(name, q, k, layout, block)
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             sm_scale, layout=layout,
                                             block=block)
    rows = tuple(q.shape[:3])
    b, h, hkv, sq, sk, d = _check_cuda(
        name, q, k, v, ("do", do, None, q.shape),
        ("lse", lse, torch.float32, rows),
        ("delta", delta, torch.float32, rows), gated=True)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib().ds_flash_attention_bwd_dkv_layout(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * hkv, sq, sk, h // hkv, d, _DTYPE_CODES[q.dtype], int(causal),
        _scale(sm_scale, d), *_gate_args("dkv", q, layout, block, causal, hkv),
        _stream(q.device))
    _raise_on_error(name, err)
    flash_attention_bwd_dkv_cuda.layout_launches += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0
flash_attention_bwd_dkv_cuda.layout_launches = 0

#: every kernel wrapper of this module, for launch-count bookkeeping; each
#: counts its dense launches in ``launches`` and its gated (``layout=``)
#: ones in ``layout_launches``
KERNELS = (flash_attention_fwd_cuda, flash_attention_bwd_dq_cuda,
           flash_attention_bwd_dkv_cuda)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.layout_launches = 0


# ---------------------------------------------------------------------------
# Autograd op and public entry
# ---------------------------------------------------------------------------
# The forward kernel as a registered operator (``torch.library``) under an
# autograd.Function: below autograd a dispatch mode sees the forward as
# one op, ``deepspeed_tpu_torch.flash_attention_fwd``, with o and lse its
# outputs, so selective activation checkpointing (``runtime/remat.py``,
# policy "dots_flash") can save them, as the JAX kernel's
# ``checkpoint_name(o, "flash_out")`` / ``("flash_lse")`` let its remat
# policy save them (``flash_attention.py`` :938-959); a ctypes launch
# called from the Function directly would be invisible to the mode.  The
# op has no autograd of its own (the Function is its only caller), which
# keeps its host cost at a dispatcher call (~15 us a call) where
# ``torch.library.custom_op``'s autograd wrapper cost ~60 us more.
_LIB = torch.library.Library("deepspeed_tpu_torch", "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float sm_scale) -> (Tensor, Tensor)")
_LIB.impl("flash_attention_fwd", flash_attention_fwd_cuda,
          "CompositeExplicitAutograd")
#: the registered forward (``(o, lse)`` of :func:`flash_attention_fwd_cuda`)
flash_fwd_op = torch.ops.deepspeed_tpu_torch.flash_attention_fwd.default


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_flash_attention_bh`` custom_vjp: the forward op saves o
    and lse; the backward runs dq (which computes delta from o) and then
    dkv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd_op(q, k, v, causal, sm_scale)
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


class _SparseAttention(torch.autograd.Function):
    """The JAX ``_sparse_attention_bh`` custom_vjp (``_sparse_fwd_rule`` /
    ``_sparse_bwd_rule``): the gated forward saves o and its v1-format lse
    whatever S is; the backward runs the gated dq (delta from o) and dkv.
    The layout gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, sm_scale, causal):
        kw = dict(layout=layout, block=block)
        o, lse = flash_attention_fwd_cuda(q, k, v, causal, sm_scale, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        # the layout object itself, whose tile maps are cached by identity
        ctx.layout, ctx.block = layout, block
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale, layout=ctx.layout,
                  block=ctx.block)
        dq, delta = flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o, **kw)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128):
    """Fused attention (``flash_attention.py:1014``).  q: ``[B, H, Sq, D]``;
    k, v: ``[B, Hkv, Sk, D]`` (GQA: ``Hkv | H``).  Returns ``[B, H, Sq, D]``
    in q's dtype, differentiable in q, k and v.

    On CUDA the head dim is 64 or 128 (GPT-2's and Llama's; the JAX
    kernels take any D up to 256).  ``block_q`` / ``block_k`` are the JAX
    tiling hints; the CUDA kernels use their own tiles (in bf16 128 x 128
    in the forward, 128 query rows x 64 keys in dq and 128 keys x 64 query
    rows in dkv; 64 x 64 in f32) and mask ragged edges themselves, and the
    plain path does not tile, so both are accepted and ignored."""
    del block_q, block_k
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 _scale(sm_scale, q.shape[-1]))
