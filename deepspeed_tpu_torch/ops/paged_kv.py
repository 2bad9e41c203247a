"""Device-side ops for the block-paged KV cache — the PyTorch port of
``deepspeed_tpu/ops/paged_kv.py`` (float pools; int8 pool records come with
the kv8 lane).

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
    """``pos`` (int, 0-d or ``[B]`` tensor) as an int64 ``[B]`` tensor."""
    pos = torch.as_tensor(pos, device=device)
    return pos.reshape(-1).to(torch.int64).expand(b)


def paged_cache_update(ck, cv, k, v, pos, block_tables, valid=None):
    """Scatter a window of new keys/values into the paged pool, in place.

    ck/cv:         [NB, HKV, block_size, hd] pool (one layer) — written
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
    bs = ck.shape[2]
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
    # advanced indices at dims 0 and 2 around the ':' put [B, T] in front:
    # the value layout is [B, T, HKV, hd]
    ck[phys, :, off] = k.transpose(1, 2).to(ck.dtype)
    cv[phys, :, off] = v.transpose(1, 2).to(cv.dtype)
    return ck, cv


def paged_gather(pool, block_tables):
    """Materialize each row's logical cache view from the pool:
    ``[NB, HKV, bs, hd]`` through ``int32 [B, NBPER]`` tables ->
    ``[B, HKV, NBPER*bs, hd]``.  Unset (scratch) entries gather garbage that
    sits past every row's valid length — callers mask by position."""
    _, hkv, bs, hd = pool.shape
    b, nbper = block_tables.shape
    g = pool[block_tables.to(torch.int64).clamp(min=0)]  # [B,NBPER,HKV,bs,hd]
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, nbper * bs, hd)
