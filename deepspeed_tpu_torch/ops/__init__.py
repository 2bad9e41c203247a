"""The port's operators: hand-written CUDA kernels for Hopper beside their
plain PyTorch versions (``flash_attention``, ``decode_attention``,
``quantized_matmul``), the int8 records (``quantization``), the paged KV
helpers, the optimizers and block-sparse attention."""

from . import sparse_attention

__all__ = ["sparse_attention"]
