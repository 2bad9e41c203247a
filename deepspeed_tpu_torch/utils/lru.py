"""Bounded true-LRU mapping for captured-program caches — a copy of
``deepspeed_tpu/utils/lru.py``.

The serving engine keys its captured CUDA graphs by decode shape
(``ServingEngine._graphs``), as the JAX engines key their jitted programs
by shape tuples.  Hot shapes must survive eviction pressure, so a *hit*
refreshes the entry (true LRU) instead of insertion-order FIFO — this class
is the one shared implementation of that policy.

``get``/``get_or_build`` are the LRU-touching reads; plain ``[]`` access and
iteration are order-preserving peeks (oldest first) so tests and probes can
inspect recency without perturbing it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional


class LRUCache:
    """OrderedDict-backed bounded mapping with true-LRU eviction."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._d: "OrderedDict[Any, Any]" = OrderedDict()

    def get(self, key, default=None):
        """LRU-touching read: a hit moves the entry to most-recent."""
        if key not in self._d:
            return default
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key, value) -> None:
        """Insert/refresh ``key`` as most-recent, evicting the
        least-recently-used entry if over capacity."""
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def get_or_build(self, key, builder: Callable[[], Any],
                     on_build: Optional[Callable[[Any], None]] = None):
        """The compiled-fn cache idiom: LRU hit, or build + insert (calling
        ``on_build(value)`` — e.g. a compile-count probe — on misses)."""
        val = self.get(key)
        if val is None:
            val = builder()
            if on_build is not None:
                on_build(val)
            self.put(key, val)
        return val

    # ------------------------------------------------- order-preserving peeks
    def __getitem__(self, key):
        return self._d[key]

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()
