"""Host-side management for the block-paged KV cache: free-list block
allocator + prefix cache (token trie over full blocks).

The port's copy of the host-only parts of ``deepspeed_tpu/inference/paged.py``
(the host and NVMe KV tiers come with their slice).  The serving engine's KV
pool is a single ``[L, num_blocks, HKV, block_size, hd]`` buffer; each
sequence owns an ``int32`` *block table* mapping its logical block index
(position // block_size) to a physical block.  This module owns the
bookkeeping:

 - :class:`BlockAllocator` — fixed pool of refcounted blocks with a FIFO
   free list.  Physical block 0 is RESERVED as scratch: pad rows, inactive
   slots, and masked-out prefill tokens write their (discarded) KV there, so
   every device call keeps a fixed shape without a dedicated pad slot.
 - :class:`PrefixCache` — automatic prefix caching at block granularity.
   Keys are ``(parent entry id, block token tuple)`` chains, so a lookup
   walks the trie block by block: a new request whose prompt shares a
   block-aligned prefix with any previously prefilled sequence reuses those
   physical blocks with zero recompute.  The cache holds one reference on
   each registered block; when the allocator runs dry the engine evicts
   least-recently-used leaf entries whose block nobody else holds.

Copy-on-write is never needed: lookups are capped below the full prompt
(at least one tail token is always recomputed) and reuse is full-block
only, so a sequence's next write position always lands in a privately
owned block — shared blocks are read-only by construction.

:func:`chain_key` / :func:`chain_keys` (content addresses of block chains)
and :func:`block_checksum` produce byte-identical results to the JAX
package's, so the two packages name the same KV blocks the same way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib
from collections import OrderedDict, deque
from typing import List, Optional, Sequence

import numpy as np

#: physical block 0 is never allocated; discarded writes are routed there
SCRATCH_BLOCK = 0


def block_checksum(block_arrays: Sequence[np.ndarray]) -> int:
    """Integrity checksum of one KV block's per-leaf byte content (crc32
    chained across leaves)."""
    c = 0
    for a in block_arrays:
        c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
    return c & 0xFFFFFFFF


#: chain keys are fixed-width blake2b digests; 16 bytes keeps the alias
#: probability below 2^-64 even across billions of cached blocks
CHAIN_KEY_BYTES = 16

#: seed digest for block 0 of every chain (the "empty prefix" state)
_CHAIN_SEED = b"\x00" * CHAIN_KEY_BYTES


def chain_key(tokens, block_index: int, block_size: int) -> bytes:
    """Content address of the ``block_index``-th KV block of a sequence:
    a rolling blake2b digest chained over every token from position 0
    through the end of that block (``h_i = H(h_{i-1} || tokens of block
    i)``), a fixed :data:`CHAIN_KEY_BYTES` bytes at any chain depth."""
    return chain_keys(tokens, int(block_index) + 1, block_size)[-1]


def chain_keys(tokens, n_blocks: int, block_size: int) -> List[bytes]:
    """:func:`chain_key` for blocks ``0..n_blocks-1`` in one pass: serialize
    the tokens once (int32) and roll the digest forward block by block."""
    bs = int(block_size)
    n = int(n_blocks) * bs
    buf = np.ascontiguousarray(np.asarray(tokens[:n], np.int32)).tobytes()
    keys: List[bytes] = []
    h = _CHAIN_SEED
    for i in range(int(n_blocks)):
        h = hashlib.blake2b(h + buf[4 * bs * i:4 * bs * (i + 1)],
                            digest_size=CHAIN_KEY_BYTES).digest()
        keys.append(h)
    return keys


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` KV blocks.

    Block ids are ``1 .. num_blocks-1`` (:data:`SCRATCH_BLOCK` is reserved).
    ``alloc`` hands out a block with refcount 1; sharing (prefix reuse, the
    prefix cache's own hold) goes through ``incref``/``decref``; a block
    returns to the free list when its count reaches zero.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (1 scratch + 1 usable), got "
                f"{num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free = deque(range(1, num_blocks))
        self._ref = [0] * num_blocks
        #: bumped on every alloc/incref/decref — anything derived from
        #: refcounts (free counts, prefix-cache evictability) is stale iff
        #: this moved, which lets the scheduler memoize its admission gate
        #: while the queue head is blocked
        self.version = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """Blocks currently held by at least one owner (excludes scratch)."""
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def snapshot(self):
        """(refcounts copy, free-list copy) for the invariant checker
        (``analysis/invariants.py``) — read-only view of allocator state."""
        return list(self._ref), list(self._free)

    def alloc(self) -> Optional[int]:
        """A fresh block with refcount 1, or ``None`` when the pool is dry
        (the caller then evicts from the prefix cache / preempts)."""
        if not self._free:
            return None
        b = self._free.popleft()
        assert self._ref[b] == 0, f"block {b} on free list with refs"
        self._ref[b] = 1
        self.version += 1
        return b

    def incref(self, block: int) -> None:
        assert self._ref[block] > 0, f"incref on unowned block {block}"
        self._ref[block] += 1
        self.version += 1

    def decref(self, block: int) -> None:
        assert self._ref[block] > 0, f"decref on unowned block {block}"
        self._ref[block] -= 1
        self.version += 1
        if self._ref[block] == 0:
            self._free.append(block)


@dataclasses.dataclass
class _PrefixEntry:
    uid: int                    # stable id for child keys (never reused)
    key: tuple                  # (parent uid | 0, token tuple)
    block: int                  # physical block holding this token span's KV
    parent: Optional["_PrefixEntry"]
    children: int = 0


class PrefixCache:
    """Token trie over FULL KV blocks: chained ``(parent, tokens)`` keys.

    ``lookup`` walks a prompt block by block and claims (increfs) the
    longest cached block-aligned prefix; ``register`` inserts a freshly
    prefilled prompt's full blocks, with the cache itself holding one
    reference so the blocks outlive the sequence.  ``evict_one`` releases
    the least-recently-used *leaf* entry whose block only the cache still
    holds — parents are only evictable once all their children are gone, so
    every cached chain stays walkable from the root.
    """

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._entries: "OrderedDict[tuple, _PrefixEntry]" = OrderedDict()
        self._next_uid = 1
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self):
        """The live trie entries (insertion/LRU order) — read-only view for
        the invariant checker (``analysis/invariants.py``)."""
        return list(self._entries.values())

    def probe(self, tokens: Sequence[int], max_tokens: int) -> int:
        """Number of leading full blocks of ``tokens[:max_tokens]`` present
        in the trie — no refcounts or recency touched (admission-gate
        peek)."""
        bs = self.block_size
        parent_uid, n = 0, 0
        for i in range(min(len(tokens), int(max_tokens)) // bs):
            e = self._entries.get(
                (parent_uid, tuple(int(t) for t in
                                   tokens[i * bs:(i + 1) * bs])))
            if e is None:
                break
            parent_uid = e.uid
            n += 1
        return n

    def lookup(self, tokens: Sequence[int], max_tokens: int,
               allocator: BlockAllocator) -> List[int]:
        """Claim the longest cached block-aligned prefix of
        ``tokens[:max_tokens]``: increfs and returns the physical block ids
        (the caller owns one reference per returned block)."""
        bs = self.block_size
        blocks: List[int] = []
        parent_uid = 0
        for i in range(min(len(tokens), max_tokens) // bs):
            key = (parent_uid,
                   tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            e = self._entries.get(key)
            if e is None:
                break
            self._entries.move_to_end(key)      # LRU touch
            allocator.incref(e.block)
            blocks.append(e.block)
            parent_uid = e.uid
        return blocks

    def register(self, tokens: Sequence[int], blocks: Sequence[int],
                 allocator: BlockAllocator) -> None:
        """Insert the chain ``tokens[i*bs:(i+1)*bs] -> blocks[i]``.  Existing
        entries win (the first prefill of a shared prompt is the canonical
        copy; a duplicate block simply isn't cached and frees with its
        sequence) — the chain continues through them either way."""
        bs = self.block_size
        parent: Optional[_PrefixEntry] = None
        for i, b in enumerate(blocks):
            key = ((parent.uid if parent else 0),
                   tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            e = self._entries.get(key)
            if e is None:
                e = _PrefixEntry(uid=self._next_uid, key=key, block=int(b),
                                 parent=parent)
                self._next_uid += 1
                allocator.incref(int(b))
                if parent is not None:
                    parent.children += 1
                self._entries[key] = e
            self._entries.move_to_end(key)
            parent = e

    def evictable(self, allocator: BlockAllocator) -> int:
        """Blocks reclaimable by repeated :meth:`evict_one` calls.  A block
        whose refcount is exactly 1 is held only by the cache; any live
        sequence using a child of an entry also holds the parent's block
        (prefix chains are claimed whole), so refcount-1 entries always
        drain leaf-first."""
        return sum(1 for e in self._entries.values()
                   if allocator.refcount(e.block) == 1)

    def evict_one(self, allocator: BlockAllocator) -> Optional[int]:
        """Release the LRU leaf entry only the cache still holds; returns
        the freed block id (truthy — block 0 is scratch and never cached)
        or ``None``."""
        for e in self._entries.values():        # oldest first
            if e.children == 0 and allocator.refcount(e.block) == 1:
                del self._entries[e.key]
                if e.parent is not None:
                    e.parent.children -= 1
                allocator.decref(e.block)
                self.evictions += 1
                return int(e.block)
        return None
