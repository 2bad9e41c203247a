"""Block-sparse self-attention — the PyTorch port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.

Reference ``ops/sparse_attention/sparse_self_attention.py:11
SparseSelfAttention`` runs Triton block-sparse sddmm/softmax/dsd kernels
over a ``SparsityConfig`` layout.  Here, as in the JAX package, the layout
gates the flash-attention kernels (``ops/flash_attention.py``,
``_SparseAttention``, the counterpart of the JAX ``_sparse_attention_bh``):
the forward, dq and dkv kernels walk only the tiles that hold a visible
(query, key) pair and mask the layout's blocks inside them, so the work
follows the live tiles.  A query row whose layout row is empty gets o = 0
(and lse = -inf, dq = 0), the JAX kernel's answer, not the dense
reference's average of v.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..flash_attention import _SparseAttention, _scale
from .sparsity_config import SparsityConfig


def _layout_tensor(layout, device) -> torch.Tensor:
    """int32 layout on ``device``, converted as the JAX package converts
    it (float32, then int32: a nonzero entry below 1 gates off).  An int32
    tensor already on ``device`` is returned as it is, so that the kernels'
    tile maps, cached by the layout tensor's identity, are built once."""
    if isinstance(layout, torch.Tensor):
        if layout.dtype == torch.int32 and layout.device == device:
            return layout
        return layout.to(device=device, dtype=torch.float32).to(torch.int32)
    return torch.from_numpy(np.asarray(layout, np.float32).astype(
        np.int32)).to(device)


def sparse_attention(q, k, v, layout, block: int,
                     sm_scale: Optional[float] = None,
                     causal: bool = False,
                     interpret: Optional[bool] = None):
    """q: [B, H, S, D]; k/v: [B, Hkv, S, D] (GQA: Hkv | H); layout:
    [1 or H, S/block, S/block] 0/1 (numpy or a tensor).

    Returns [B, H, S, D], differentiable in q, k and v.  ``causal=True``
    additionally lower-triangularizes inside diagonal blocks (configs built
    with ``attention="unidirectional"`` already gate strictly-upper blocks
    off).  ``interpret`` is the JAX keyword for Pallas' interpret mode:
    accepted and ignored (CPU tensors take the plain versions, CUDA tensors
    the gated kernels).  A layout passed as an int32 tensor on q's device
    is used as it is, so its tile maps are built at its first call only; a
    numpy layout is copied to the device at every call."""
    del interpret
    b, h, s, d = q.shape
    hkv = k.shape[1]
    assert h % hkv == 0, f"GQA needs num_heads {h} % kv_heads {hkv} == 0"
    n = layout.shape[-1]
    assert s % block == 0 and s // block == n, (
        f"seq {s} != layout blocks {n} x block {block}")
    assert layout.shape[0] in (1, h)
    # a one-head layout goes on as it is: the plain versions and the tile
    # maps broadcast it to every head
    return _SparseAttention.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(),
                                  _layout_tensor(layout, q.device), block,
                                  _scale(sm_scale, d), causal)


class SparseSelfAttention:
    """Config-driven wrapper (reference ``sparse_self_attention.py:11``).
    Layouts are cached per sequence length (numpy, as the JAX package's)
    and their int32 device tensors per (length, device), which
    ``sparse_attention`` passes on unconverted, so the kernels' tile maps
    are built at the first call of each length only."""

    def __init__(self, sparsity_config: SparsityConfig,
                 attn_mask_mode: str = "mul", max_seq_length: int = 2048):
        self.sparsity_config = sparsity_config
        self._layouts = {}
        self._device_layouts = {}

    def get_layout(self, seq_len: int):
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def _device_layout(self, seq_len: int, device) -> torch.Tensor:
        key = (seq_len, str(device))
        if key not in self._device_layouts:
            self._device_layouts[key] = _layout_tensor(
                self.get_layout(seq_len), device)
        return self._device_layouts[key]

    def __call__(self, q, k, v, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        assert rpe is None and key_padding_mask is None and attn_mask is None, (
            "rpe/masks not supported yet (reference supports them via "
            "kernel arguments)")
        s = q.shape[2]
        causal = getattr(self.sparsity_config, "attention",
                         "bidirectional") == "unidirectional"
        return sparse_attention(q, k, v, self._device_layout(s, q.device),
                                self.sparsity_config.block, causal=causal)


def sparse_attention_reference(q, k, v, layout, block: int,
                               causal: bool = False):
    """Dense einsum reference honoring the block layout, for the tests (the
    JAX package's, which averages v over a row whose layout row is empty:
    the kernels give 0 there)."""
    b, h, s, d = q.shape
    if k.shape[1] != h:  # GQA: repeat KV heads for the dense math
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    mask = np.kron(np.asarray(layout, bool),
                   np.ones((block, block), bool))  # [H, S, S]
    if causal:
        mask = mask & np.tril(np.ones((s, s), bool))[None]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / \
        math.sqrt(d)
    scores = torch.where(torch.from_numpy(mask).to(q.device)[None], scores,
                         -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
