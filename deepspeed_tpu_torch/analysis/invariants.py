"""Paged-state invariant checker: an O(blocks) audit of the serving
engine's host-side bookkeeping after every scheduler round — the port's
copy of ``deepspeed_tpu/analysis/invariants.py`` for what the port has:
the allocator's refcounts and free list, the block tables, the slots'
held lists, the prefix trie, and the int8 pool's scale ledger.  The
audits of the host KV tier (``audit_host_store``, ``residency-
conservation``), of the replica router (``audit_router``) and of incident
bundles (``audit_incident_bundle``) wait for the fleet layers (ROADMAP
Queue A 9), as do the resident-window table shape and the dp groups'
scratch blocks (Queue A 8).

Named invariants (the :class:`PagedStateError` ``invariant`` field):

``refcount-conservation``
    Every block's refcount equals the number of holders that can ever
    decref it: slot ``held`` lists + prefix-trie entries.  A higher count
    is a leak (the block can never return to the free list); a lower one
    is a double-free in waiting.
``free-list-disjoint``
    The free list is duplicate-free, contains only refcount-0 blocks,
    never the scratch block, and shares no block with any holder; and
    every refcount-0 non-scratch block IS on the free list.
``scratch-aliasing``
    Scratch block 0 is never held, never cached in the trie, and never
    addressed by the *allocated* span of a live table (table entry 0
    doubles as the "unset" marker, so an unset entry inside a span the
    sequence needs means its KV lands in — and reads garbage from — the
    scratch block).
``trie-parent-child``
    Chains stay walkable (every entry's parent is a live entry) and
    ``children`` counters match the live child count — the two facts
    ``evict_one``'s leaf-first drain depends on.  "parent block refcount
    >= child block refcount" is NOT an invariant: ``register``'s
    first-writer-wins dedup lets a request that prefilled duplicate
    content hold its own copy of the parent span while the trie caches the
    child span's block.
``length-occupancy``
    Per active slot: the table's nonzero entries form one contiguous
    leading span, that span matches the slot's ``held`` blocks exactly, no
    physical block appears twice in a slot, and the span covers every
    token the slot has committed (``lengths`` / prefill base).  Inactive
    slots are fully zeroed.
``scale-lockstep``
    int8-KV engines only (``quantize="kv8"``): the engine's ledger of
    blocks with live scale rows covers every owned block, holds only
    blocks with a nonzero refcount, and never the scratch block.

The audit reads pure host state (numpy + lists) — no device sync — and
runs in O(num_blocks + trie entries).  ``ServingEngine`` calls it after
every scheduler iteration when ``debug_checks`` is on.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..inference.paged import SCRATCH_BLOCK

class PagedStateError(RuntimeError):
    """A paged-KV bookkeeping invariant does not hold; ``invariant`` names
    which one (see module docstring)."""

    def __init__(self, invariant: str, detail: str):
        super().__init__(
            f"paged-state invariant '{invariant}' violated: {detail}")
        self.invariant = invariant
        self.detail = detail


def _blocks_for(num_tokens: int, block_size: int) -> int:
    return -(-int(num_tokens) // int(block_size))


def audit_paged_state(allocator, tables, held, *,
                      prefix=None,
                      active_needs: Optional[Dict[int, int]] = None,
                      block_size: int = 1,
                      scale_live=None) -> None:
    """Verify every invariant over one engine's host state; raises
    :class:`PagedStateError` naming the first violated invariant.

    allocator:     :class:`~deepspeed_tpu_torch.inference.paged.BlockAllocator`.
    tables:        int array ``[slots, nbper]`` of physical block ids
                   (entry 0 = scratch doubles as "unset").
    held:          per-slot list of owned block ids (the host ownership
                   record the release path decrefs).
    prefix:        optional :class:`PrefixCache` (``None`` in bucketed /
                   prefix-off mode).
    active_needs:  ``slot -> committed token count`` for live slots; slots
                   absent from the map must be fully released.
    block_size:    tokens per block (converts needs to table spans).
    scale_live:    optional set of block ids whose int8-KV scale rows are
                   live (``quantize="kv8"`` engines); ``None`` skips the
                   ``scale-lockstep`` check entirely.
    """
    ref, free = allocator.snapshot()
    num_blocks = allocator.num_blocks
    entries = prefix.entries() if prefix is not None else []
    active_needs = active_needs or {}
    scratch = frozenset({SCRATCH_BLOCK})

    # ---- refcount-conservation: owners (held lists + trie) == refcounts
    expected = [0] * num_blocks
    for slot, blocks in enumerate(held):
        for b in blocks:
            if not (0 <= int(b) < num_blocks):
                raise PagedStateError(
                    "refcount-conservation",
                    f"slot {slot} holds out-of-range block {b} "
                    f"(pool has {num_blocks})")
            expected[int(b)] += 1
    for e in entries:
        if not (0 <= int(e.block) < num_blocks):
            raise PagedStateError(
                "refcount-conservation",
                f"trie entry uid={e.uid} caches out-of-range block "
                f"{e.block} (pool has {num_blocks})")
        expected[int(e.block)] += 1
    for b in range(num_blocks):
        if b in scratch:
            continue
        if ref[b] != expected[b]:
            kind = "leaked (unreclaimable)" if ref[b] > expected[b] \
                else "under-counted (double-free in waiting)"
            raise PagedStateError(
                "refcount-conservation",
                f"block {b}: refcount {ref[b]} != {expected[b]} owners "
                f"(held lists + trie entries) — {kind}")
    for sb in sorted(scratch):
        if ref[sb] != 0 or expected[sb] != 0:
            raise PagedStateError(
                "scratch-aliasing",
                f"scratch block {sb} is owned (refcount "
                f"{ref[sb]}, {expected[sb]} holders) — "
                "it must stay unallocated")

    # ---- free-list-disjoint
    free_set = set(int(b) for b in free)
    if len(free_set) != len(free):
        raise PagedStateError("free-list-disjoint",
                              "free list contains duplicate block ids")
    if free_set & scratch:
        raise PagedStateError(
            "free-list-disjoint",
            f"scratch block(s) {sorted(free_set & scratch)} on the free "
            "list")
    for b in free_set:
        if ref[b] != 0:
            raise PagedStateError(
                "free-list-disjoint",
                f"block {b} is on the free list with refcount {ref[b]}")
        if expected[b] != 0:
            raise PagedStateError(
                "free-list-disjoint",
                f"block {b} is on the free list but has {expected[b]} "
                "live holder(s)")
    for b in range(num_blocks):
        if b in scratch:
            continue
        if ref[b] == 0 and b not in free_set:
            raise PagedStateError(
                "free-list-disjoint",
                f"block {b} has refcount 0 but is not on the free list "
                "(leaked out of the pool)")

    # ---- trie-parent-child
    live = set(id(e) for e in entries)
    child_count: Dict[int, int] = {}
    for e in entries:
        if int(e.block) in scratch:
            raise PagedStateError(
                "scratch-aliasing",
                f"trie entry uid={e.uid} caches a scratch block "
                f"({e.block})")
        if e.parent is not None:
            if id(e.parent) not in live:
                raise PagedStateError(
                    "trie-parent-child",
                    f"trie entry uid={e.uid} has an evicted parent "
                    f"(uid={e.parent.uid}) — chain no longer walkable")
            child_count[id(e.parent)] = child_count.get(id(e.parent), 0) + 1
    for e in entries:
        actual = child_count.get(id(e), 0)
        if e.children != actual:
            raise PagedStateError(
                "trie-parent-child",
                f"trie entry uid={e.uid}: children counter {e.children} "
                f"!= {actual} live children")
        # a parent with live children must keep its own cache hold (its
        # refcount can never drop below the 1 the conservation pass
        # attributes to the entry itself) — the weakest sound form of
        # "no child outlives its parent"; see module docstring for why
        # "parent refs >= child refs" is NOT sound
        if actual and ref[int(e.block)] < 1:
            raise PagedStateError(
                "trie-parent-child",
                f"trie entry uid={e.uid} has {actual} live children but "
                f"its block {e.block} is unreferenced")

    # ---- scale-lockstep (int8 KV only): scale rows live <=> block owned
    if scale_live is not None:
        if scratch & set(int(b) for b in scale_live):
            raise PagedStateError(
                "scale-lockstep",
                "a scratch block is in the live-scale ledger — scratch "
                "is never owned, its scale row is write-only garbage")
        for b in scale_live:
            if not (0 <= int(b) < num_blocks) or ref[int(b)] == 0:
                raise PagedStateError(
                    "scale-lockstep",
                    f"block {b} is in the live-scale ledger but has no "
                    "owner (refcount 0) — a stale scale row survived the "
                    "block free")
        for b in range(num_blocks):
            if b in scratch:
                continue
            if (ref[b] > 0 or expected[b] > 0) and b not in scale_live:
                raise PagedStateError(
                    "scale-lockstep",
                    f"block {b} is owned (refcount {ref[b]}) but missing "
                    "from the live-scale ledger — its reads would "
                    "dequantize stale scales")

    # ---- length-occupancy + scratch-aliasing over the tables
    for slot in range(len(tables)):
        row = tables[slot]
        span = 0
        while span < len(row) and int(row[span]) != SCRATCH_BLOCK:
            span += 1
        for li in range(span, len(row)):
            if int(row[li]) != SCRATCH_BLOCK:
                raise PagedStateError(
                    "length-occupancy",
                    f"slot {slot}: table entry {li} set after an unset "
                    f"entry at {span} — allocated span must be contiguous")
        owned = sorted(int(b) for b in held[slot])
        mapped = sorted(int(row[li]) for li in range(span))
        hit = scratch.intersection(mapped)
        if hit:
            raise PagedStateError(
                "scratch-aliasing",
                f"slot {slot}: table span maps scratch block(s) "
                f"{sorted(hit)} — sequence KV would alias scratch garbage")
        if len(set(mapped)) != len(mapped):
            raise PagedStateError(
                "length-occupancy",
                f"slot {slot}: a physical block appears twice in its "
                f"table span {mapped}")
        if owned != mapped:
            raise PagedStateError(
                "length-occupancy",
                f"slot {slot}: table span blocks {mapped} diverge from "
                f"the held record {owned}")
        if slot in active_needs:
            need_span = _blocks_for(active_needs[slot], block_size)
            if span < need_span:
                raise PagedStateError(
                    "scratch-aliasing",
                    f"slot {slot}: {active_needs[slot]} committed tokens "
                    f"need {need_span} table entries but only {span} are "
                    "set — writes past the span land in the scratch block")
        elif span or held[slot]:
            raise PagedStateError(
                "length-occupancy",
                f"slot {slot} is inactive but still maps {span} table "
                f"entr(ies) / holds {len(held[slot])} block(s)")


def audit_serving_engine(srv, active) -> None:
    """Engine-facing wrapper: pulls the :class:`ServingEngine` fields and
    derives each active slot's committed-token count (decode: host
    ``lengths``; prefill: the chunk base already written).

    The audit records itself on the engine's trace timeline — an
    ``invariant_audit`` instant per run, or an ``invariant_violation``
    naming the broken invariant *before* the raise, so a fatal audit is
    visible in the exported trace next to the scheduler events that
    corrupted the state."""
    needs = {slot: max(int(srv._lengths[slot]), st.base)
             for slot, st in active.items()}
    timeline = getattr(srv, "timeline", None)
    try:
        audit_paged_state(srv._alloc, srv._tables, srv._held,
                          prefix=srv._prefix, active_needs=needs,
                          block_size=srv.block_size,
                          scale_live=(srv._kv_scale_live
                                      if getattr(srv, "kv_quant", False)
                                      else None))
    except PagedStateError as e:
        if timeline is not None:
            timeline.instant("invariant_violation", invariant=e.invariant,
                             detail=e.detail)
        raise
    if timeline is not None:
        timeline.instant("invariant_audit", slots_active=len(needs),
                         blocks_in_use=srv._alloc.blocks_in_use)
