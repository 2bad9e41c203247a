"""Fixed row counts for the cached path's products (llama, OPT, the MoE's
experts), so a row's bf16 result does not depend on the rows that share
its call.

A GEMM library picks its kernel, and so each output's summation order, by
the row count.  On the H100 that moved near-tie bf16 tokens between
``generate`` and the server: Llama-3-8B's w2 (14336, 4096) summed a
128-row prefill window otherwise than 256 or more rows, and OPT-13B's
matmuls summed 300-512 rows otherwise than 256.  The JAX package needs
none of this on the TPU.  Two modes (:data:`ROWS`):

 - ``prefill``: a window's rows run in blocks of exactly 256 (the last
   zero-padded), so every prefill row sums in a 256-row call;
 - ``decode``: a single-position step (and a stepwise verify's per-position
   call) pads to at least 8 rows and never splits: decode is bound by
   reading the weights, which one call reads once at any row count, and a
   server's 1-8 slots all run at 8.

The pad rows are zeros and are dropped from the result.
"""

from __future__ import annotations

from typing import Callable

import torch

#: mode -> (rows, split): ``split`` runs blocks of exactly ``rows``;
#: otherwise ``rows`` is a floor and the call is never split
ROWS = {"prefill": (256, True), "decode": (8, False)}


def fixed_rows(fn: Callable, x: torch.Tensor, mode: str, unit: int = 1):
    """``fn(x)`` for ``x [..., R, K]`` -> ``[..., R, N]`` (``fn`` row by
    row) computed on row counts set by ``mode`` (:data:`ROWS`) and not by
    R.  ``unit`` scales the decode floor (an expert's bucket rows come
    ``unit`` = capacity to a group, so the floor counts groups)."""
    rows, split = ROWS[mode]
    r = x.shape[-2]
    step = rows if split else max(r, rows * unit)
    pad = -r % step
    if pad:
        x = torch.cat([x, x.new_zeros(tuple(x.shape[:-2]) +
                                      (pad, x.shape[-1]))], dim=-2)
    if r + pad == step:
        return fn(x)[..., :r, :]
    return torch.cat([fn(x[..., i:i + step, :])
                      for i in range(0, r + pad, step)], dim=-2)[..., :r, :]


def fixed_row_mm(mm: Callable, mode: str) -> Callable:
    """``mm(y, name, dtype)`` on ``y [..., K]``, every leading position a
    row, through :func:`fixed_rows`."""
    def fixed(y, name, dtype):
        lead = tuple(y.shape[:-1])
        out = fixed_rows(lambda f: mm(f, name, dtype),
                         y.reshape(-1, y.shape[-1]), mode)
        return out.reshape(lead + (out.shape[-1],))
    return fixed
