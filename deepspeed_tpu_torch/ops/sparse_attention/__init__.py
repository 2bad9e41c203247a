"""Block-sparse attention (reference ``deepspeed/ops/sparse_attention``),
the PyTorch port of ``deepspeed_tpu/ops/sparse_attention``: the sparsity
*structures* (Fixed, Variable, BigBird, BSLongformer, LocalSlidingWindow)
produce block-level layouts, executed by the flash kernels' layout gate
(``ops/flash_attention.py``) instead of Triton block-sparse matmuls."""

from .sparse_self_attention import SparseSelfAttention, sparse_attention
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              LocalSlidingWindowSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)

__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig",
           "SparseSelfAttention", "sparse_attention"]
