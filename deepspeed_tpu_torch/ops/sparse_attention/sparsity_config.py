"""Sparsity structures: block-level attention layouts — the PyTorch port's
copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``.

Reference ``ops/sparse_attention/sparsity_config.py`` (classes at
:94/:243/:421/:559/:686): each config builds a **layout**, a
``[num_heads, S/block, S/block]`` 0/1 numpy matrix saying which (query
block, key block) pairs are computed.  The structures are Sparse
Transformers' fixed pattern, BigBird's random + window + global blocks and
Longformer's sliding window + global blocks.  The code is numpy only and
gives the JAX package's layouts bit for bit (the random blocks of Variable
and BigBird are drawn from ``np.random.default_rng(0)`` as there); the
port executes a layout through the flash kernels' tile gate
(``ops/flash_attention.py``, ``layout=``) instead of Triton block-sparse
matmuls.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: dense layout scaffold + utilities."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be a multiple of the "
                f"sparsity block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), np.int64)

    def check_and_propagate_first_head_layout(self, layout) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks visible (reference :243 — for testing/parity)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers fixed pattern (reference :94): local blocks within
    a stride window, plus "summary" global columns — the last
    ``num_global_blocks`` block-columns of each window attend/are attended
    across windows (unidirectional keeps only past windows)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention
        if horizontal_global_attention:
            assert attention == "bidirectional", (
                "horizontal (row) global attention is only meaningful "
                "bidirectionally")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1:
            assert different_layout_per_head, (
                "different global patterns require different_layout_per_head")
        assert num_local_blocks % num_global_blocks == 0, (
            f"num_local_blocks {num_local_blocks} must be a multiple of "
            f"num_global_blocks {num_global_blocks}")
        assert num_different_global_patterns * num_global_blocks <= \
            num_local_blocks, (
                f"{num_different_global_patterns} global patterns x "
                f"{num_global_blocks} global blocks don't fit a window of "
                f"{num_local_blocks} local blocks")
        self.num_different_global_patterns = num_different_global_patterns

    def _set_local(self, layout, h, n):
        for start in range(0, n, self.num_local_blocks):
            end = min(start + self.num_local_blocks, n)
            for q in range(start, end):
                hi = (q + 1) if self.attention == "unidirectional" else end
                layout[h, q, start:hi] = 1
        return layout

    def _global_cols(self, h, window_start: int) -> List[int]:
        """Summary block-columns of one window for head ``h``: the window's
        tail ``num_global_blocks`` columns, shifted back per head when
        ``num_different_global_patterns > 1`` so heads summarize different
        positions."""
        pat = h % self.num_different_global_patterns
        first = window_start + self.num_local_blocks - \
            (pat + 1) * self.num_global_blocks
        return list(range(max(first, window_start),
                          max(first, window_start) + self.num_global_blocks))

    def _set_global(self, layout, h, n):
        for window_start in range(0, n, self.num_local_blocks):
            for c in self._global_cols(h, window_start):
                if c >= n:
                    continue
                if self.attention == "unidirectional":
                    # later queries attend back to past summary columns
                    layout[h, c + 1:, c] = 1
                else:
                    layout[h, :, c] = 1
                    if self.horizontal_global_attention:
                        layout[h, c, :] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        heads = range(self.num_heads) if self.different_layout_per_head \
            else range(1)
        for h in heads:
            self._set_local(layout, h, n)
            self._set_global(layout, h, n)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed's generalization (reference :421): custom local window sizes
    (``local_window_blocks``: first windows get listed sizes, last size
    repeats) and explicit global block indices."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None:
            assert len(global_block_end_indices) == \
                len(self.global_block_indices)
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _set_local(self, layout, h, n):
        start = 0
        sizes = list(self.local_window_blocks)
        while start < n:
            size = sizes.pop(0) if sizes else self.local_window_blocks[-1]
            end = min(start + size, n)
            for q in range(start, end):
                hi = (q + 1) if self.attention == "unidirectional" else end
                layout[h, q, start:hi] = 1
            start = end
        return layout

    def _globals(self, n):
        cols = []
        if self.global_block_end_indices is None:
            cols = [c for c in self.global_block_indices if c < n]
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                cols.extend(range(s, min(e, n)))
        return cols

    def _set_global(self, layout, h, n):
        for c in self._globals(n):
            if self.attention == "unidirectional":
                layout[h, c:, c] = 1
            else:
                layout[h, :, c] = 1
                if self.horizontal_global_attention:
                    layout[h, c, :] = 1
        return layout

    def _set_random(self, layout, h, n, rng):
        for q in range(n):
            hi = (q + 1) if self.attention == "unidirectional" else n
            if hi <= 0:
                continue
            ks = rng.integers(0, hi, size=self.num_random_blocks)
            layout[h, q, ks] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(0)  # deterministic layouts
        heads = range(self.num_heads) if self.different_layout_per_head \
            else range(1)
        for h in heads:
            self._set_local(layout, h, n)
            self._set_global(layout, h, n)
            if self.num_random_blocks:
                self._set_random(layout, h, n, rng)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (reference :559): random + sliding-window + global blocks."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        g = self.num_global_blocks
        rng = np.random.default_rng(0)
        heads = range(self.num_heads) if self.different_layout_per_head \
            else range(1)
        for h in heads:
            for q in range(n):
                lo, hi = max(0, q - w), min(n, q + w + 1)
                if self.attention == "unidirectional":
                    hi = q + 1
                layout[h, q, lo:hi] = 1                      # sliding window
            layout[h, :, :g] = 1                             # global columns
            if self.attention == "bidirectional":
                layout[h, :g, :] = 1                         # global rows
            for q in range(n):                               # random
                hi = (q + 1) if self.attention == "unidirectional" else n
                ks = rng.integers(0, max(hi, 1),
                                  size=self.num_random_blocks)
                layout[h, q, ks] = 1
        if self.attention == "unidirectional":
            tri = np.tril(np.ones((n, n), np.int64))
            layout *= tri[None]
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (reference :686): sliding window + explicit
    global block indices."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        if self.global_block_end_indices is None:
            cols = [c for c in self.global_block_indices if c < n]
        else:
            cols = []
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                cols.extend(range(s, min(e, n)))
        for h in range(self.num_heads if self.different_layout_per_head
                       else 1):
            for q in range(n):
                layout[h, q, max(0, q - w):min(n, q + w + 1)] = 1
            for c in cols:
                layout[h, :, c] = 1
                layout[h, c, :] = 1
        if self.attention == "unidirectional":
            layout *= np.tril(np.ones((n, n), np.int64))[None]
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference local attention variant)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block, False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for q in range(n):
            lo = max(0, q - w)
            hi = (q + 1) if self.attention == "unidirectional" \
                else min(n, q + w + 1)
            layout[0, q, lo:hi] = 1
        return self.check_and_propagate_first_head_layout(layout)
