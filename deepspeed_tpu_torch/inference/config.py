"""Inference config (reference ``deepspeed/inference/config.py``).

The port's copy of ``deepspeed_tpu/inference/config.py``: the same keys and
aliases, with :attr:`DeepSpeedInferenceConfig.torch_dtype` in place of
``jnp_dtype``.  Keys whose feature is not ported yet are accepted here and
refused by the engine (``inference/engine.py``), never ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..runtime.config_utils import DeepSpeedConfigModel, Field


@dataclasses.dataclass(init=False)
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    """Reference ``inference/config.py:44``."""
    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


@dataclasses.dataclass(init=False)
class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    """Reference ``inference/config.py:62``."""
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = Field(default_factory=lambda: [1])
    type: str = "standard"


@dataclasses.dataclass(init=False)
class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group_size: int = 128
    num_bits: int = 8
    type: str = "weight"
    shard_multiple: Optional[int] = None


@dataclasses.dataclass(init=False)
class ZeroInferenceConfig(DeepSpeedConfigModel):
    enabled: bool = False
    pin_layers: int = 0
    prefetch: int = 1
    sync_every: int = 1


@dataclasses.dataclass(init=False)
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    """Reference ``inference/config.py:123`` key set."""
    kernel_inject: bool = Field(False, alias="replace_with_kernel_inject")
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = Field(
        default_factory=DeepSpeedTPConfig, alias="tp")
    enable_cuda_graph: bool = False
    zero: Dict[str, Any] = Field(default_factory=dict)
    triangular_masking: bool = True
    moe: DeepSpeedMoEConfig = Field(default_factory=DeepSpeedMoEConfig)
    quant: QuantizationConfig = Field(default_factory=QuantizationConfig)
    zero_inference: ZeroInferenceConfig = Field(
        default_factory=ZeroInferenceConfig)
    checkpoint: Optional[Any] = None
    base_dir: str = ""
    max_tokens: int = Field(1024, alias="max_out_tokens")
    min_out_tokens: int = Field(1, alias="min_tokens")
    replace_method: str = "auto"
    injection_policy: Optional[Dict] = Field(None, alias="injection_dict")
    return_tuple: bool = True
    training_mp_size: int = 1
    max_batch_size: int = Field(1, alias="max_out_batch")
    sequence_parallel: int = Field(1, alias="sp")

    @property
    def torch_dtype(self):
        import torch

        return {
            "float16": torch.float16, "fp16": torch.float16,
            "half": torch.float16,
            "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float32": torch.float32, "fp32": torch.float32,
            "float": torch.float32,
        }[str(self.dtype).replace("torch.", "")]
