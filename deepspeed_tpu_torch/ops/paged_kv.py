"""Device-side ops for the block-paged KV cache — the PyTorch port of
``deepspeed_tpu/ops/paged_kv.py``, float pools and int8 pool records.

Layout contract (per layer slice of the stacked pool):

 - pool: ``[NB, HKV, block_size, hd]`` — the batch dim of the contiguous
   layout becomes the physical-block dim and the length dim the in-block
   offset, so the model's ``init_cache(num_blocks, block_size, dtype)``
   hook builds a pool unchanged.
 - block table: ``int32 [B, NBPER]`` — each row maps a sequence's logical
   block index (``position // block_size``) to a physical block.  Entry 0
   is the reserved scratch block (``inference/paged.py``), which doubles as
   the "unset" marker: reads of unset blocks are masked by position, writes
   of invalid tokens are routed there explicitly.
 - int8 pool records (``quantize="kv8"`` serving): each pool leaf becomes
   ``{"qp": int8 codes [NB, HKV, bs, hd], "ps": bf16 scales [NB, HKV,
   bs]}``, one scale per token vector computed at write time from that
   vector alone (``ops.quantization.quantize_kv``), so no stored code is
   ever re-scaled.  Scale rows ride under the same physical block ids as
   their codes.

The JAX ops return a new pool; these write the pool in place (the serving
engine owns one pool for its whole life, so a copy per step would only cost
bandwidth).  Everything here is plain PyTorch (scatter / gather); the CUDA
kernels that walk the block table in-kernel live in
``ops/decode_attention.py``.
"""

from __future__ import annotations

import torch


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Blocks needed to cover ``num_tokens`` positions (ceil division) —
    the one accounting formula the allocator and scheduler agree on."""
    return -(-int(num_tokens) // int(block_size))


def _row_positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or ``[B]`` tensor) as an int64 ``[B]`` tensor; an
    int is filled on the device, never copied from the host, so the
    decode step stays capturable in a CUDA graph."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((b,), int(pos), dtype=torch.int64, device=device)
    return pos.to(device).reshape(-1).to(torch.int64).expand(b)


#: scale-table dtype: absmax/127 of activation-range values always fits,
#: and its 2^-9 relative rounding sits below the int8 error itself
SCALE_DTYPE = torch.bfloat16

_PQ_KEYS = frozenset({"qp", "ps"})


def is_quantized_pool(leaf) -> bool:
    """True for an int8 pool record ``{"qp": codes, "ps": scales}``."""
    return isinstance(leaf, dict) and set(leaf) == _PQ_KEYS


def pool_payload(leaf):
    """The code/payload tensor of a pool leaf: ``qp`` for records, the
    leaf itself otherwise — shape probes go here."""
    return leaf["qp"] if is_quantized_pool(leaf) else leaf


def quantize_pool(pool, scale_dtype=None, device=None):
    """Int8 records for every leaf of a float pool (``init_cache`` output,
    any nesting): zero codes plus a zero scale table shaped
    ``payload.shape[:-1]``.  Zero scales read unwritten slots as exactly
    0.0, like the float pool's zero init.  ``pool`` may live on the
    ``meta`` device (shapes only); the records go to ``device``, by default
    the pool's own."""
    scale_dtype = scale_dtype or SCALE_DTYPE
    if isinstance(pool, dict):
        return {k: quantize_pool(v, scale_dtype, device)
                for k, v in pool.items()}
    dev = pool.device if device is None else device
    return {"qp": torch.zeros(pool.shape, dtype=torch.int8, device=dev),
            "ps": torch.zeros(pool.shape[:-1], dtype=scale_dtype, device=dev)}


def _scatter_one(pool, win, phys, off) -> None:
    """Write a [B, HKV, T, hd] window into one pool leaf at the [B, T]
    (physical block, in-block offset) targets, quantizing on write when the
    leaf is an int8 record (``paged_kv.py:264-280``).  Advanced indices at
    dims 0 and 2 around the ':' put [B, T] in front: the value layout is
    [B, T, HKV, ...].  Duplicate targets only occur on the scratch block."""
    if not is_quantized_pool(pool):
        pool[phys, :, off] = win.transpose(1, 2).to(pool.dtype)
        return
    from .quantization import quantize_kv

    codes, scale = quantize_kv(win, pool["ps"].dtype)
    pool["qp"][phys, :, off] = codes.transpose(1, 2)
    pool["ps"][phys, :, off] = scale.transpose(1, 2)


def paged_cache_update(ck, cv, k, v, pos, block_tables, valid=None):
    """Scatter a window of new keys/values into the paged pool, in place.

    ck/cv:         [NB, HKV, block_size, hd] pool (one layer), or its int8
                   record — written
    k/v:           [B, HKV, T, hd] — T new tokens per row
    pos:           int or int32 ``[B]`` — global position of ``k[:, :, 0]``
                   per row (T == 1 decode: each row's own position; T > 1
                   chunked prefill: each row's chunk base)
    block_tables:  int32 [B, NBPER]
    valid:         optional int32 [B] — tokens of the T-window that are
                   real (default all T).  Invalid tokens, and positions
                   past the table's reach, write to scratch block 0
                   (``paged_kv.py:283-302``), the only place duplicate
                   targets occur.
    """
    b, hkv, t, hd = k.shape
    bs = pool_payload(ck).shape[2]
    nbper = block_tables.shape[1]
    dev = k.device
    ar = torch.arange(t, device=dev)
    p = _row_positions(pos, b, dev)[:, None] + ar[None, :]            # [B, T]
    ok = torch.ones((b, t), dtype=torch.bool, device=dev) if valid is None \
        else ar[None, :] < torch.as_tensor(valid, device=dev).reshape(-1, 1)
    li = torch.div(p, bs, rounding_mode="floor")
    ok = ok & (li >= 0) & (li < nbper)
    phys = torch.gather(block_tables.to(torch.int64), 1,
                        li.clamp(0, nbper - 1))
    phys = torch.where(ok, phys.clamp(min=0), 0)                     # [B, T]
    off = torch.where(ok, p % bs, 0)                                  # [B, T]
    _scatter_one(ck, k, phys, off)
    _scatter_one(cv, v, phys, off)
    return ck, cv


def paged_gather(pool, block_tables, out_dtype=None):
    """Materialize each row's logical cache view from the pool:
    ``[NB, HKV, bs, hd]`` through ``int32 [B, NBPER]`` tables ->
    ``[B, HKV, NBPER*bs, hd]``.  Unset (scratch) entries gather garbage that
    sits past every row's valid length — callers mask by position.  An int8
    record gathers codes and scales and dequantizes (f32 expand, one cast to
    ``out_dtype``, float32 by default; ``paged_kv.py:362-379``);
    ``out_dtype`` never touches a float pool."""
    if is_quantized_pool(pool):
        from .quantization import dequantize_kv

        codes = paged_gather(pool["qp"], block_tables)
        b, nbper = block_tables.shape
        hkv, bs = pool["ps"].shape[1], pool["ps"].shape[2]
        s = pool["ps"][block_tables.to(torch.int64).clamp(min=0)]
        s = s.permute(0, 2, 1, 3).reshape(b, hkv, nbper * bs)
        return dequantize_kv(codes, s, out_dtype or torch.float32)
    _, hkv, bs, hd = pool.shape
    b, nbper = block_tables.shape
    g = pool[block_tables.to(torch.int64).clamp(min=0)]  # [B,NBPER,HKV,bs,hd]
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, nbper * bs, hd)
