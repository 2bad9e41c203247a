"""ZeRO config schema — the port's copy of
``deepspeed_tpu/runtime/zero/config.py`` (reference
``deepspeed/runtime/zero/config.py:79``), on the standard-library config
model.  The keys are all accepted.  At world size 1 every stage is the
whole partition, so the engine runs stages 0-3 alike; ``offload_optimizer``
and ``offload_param`` select the host tiers (``runtime/zero/offload.py``,
``runtime/zero/param_stream.py``)."""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

from ..config_utils import DeepSpeedConfigModel, Field


class ZeroStageEnum(int, Enum):
    disabled = 0
    optimizer_states = 1
    gradients = 2
    weights = 3
    max_stage = 3


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclasses.dataclass(init=False)
class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """Reference ``zero/offload_config.py:20``."""
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False

    def __init__(self, **data):
        super().__init__(**data)
        self.device = OffloadDeviceEnum(self.device)


@dataclasses.dataclass(init=False)
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """Reference ``zero/offload_config.py:51``."""
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    def __init__(self, **data):
        super().__init__(**data)
        self.device = OffloadDeviceEnum(self.device)


@dataclasses.dataclass(init=False)
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    """Reference ``zero/config.py:79`` key set."""
    stage: ZeroStageEnum = ZeroStageEnum.disabled
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
    sub_group_size: int = int(1e9)
    cpu_offload_param: Optional[bool] = None  # deprecated spellings
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None
    prefetch_bucket_size: int = Field(int(5e7),
                                      alias="stage3_prefetch_bucket_size")
    param_persistence_threshold: int = Field(
        int(1e5), alias="stage3_param_persistence_threshold")
    model_persistence_threshold: int = Field(
        int(1e14), alias="stage3_model_persistence_threshold")
    max_live_parameters: int = Field(int(1e9),
                                     alias="stage3_max_live_parameters")
    max_reuse_distance: int = Field(int(1e9),
                                    alias="stage3_max_reuse_distance")
    gather_16bit_weights_on_model_save: bool = Field(
        False, alias="stage3_gather_16bit_weights_on_model_save")
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    def __init__(self, **data):
        super().__init__(**data)
        self.stage = ZeroStageEnum(int(self.stage))
        if isinstance(self.offload_param, dict):
            self.offload_param = DeepSpeedZeroOffloadParamConfig(
                **self.offload_param)
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(
                **self.offload_optimizer)
        # deprecated cpu_offload* spellings fold into the offload sub-configs
        if self.cpu_offload and self.offload_optimizer is None:
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(
                device="cpu")
        if self.cpu_offload_param and self.offload_param is None:
            self.offload_param = DeepSpeedZeroOffloadParamConfig(device="cpu")
        if self.overlap_comm is None:
            # reference default: True for stage 3 else False
            self.overlap_comm = self.stage == ZeroStageEnum.weights

    def offload_enabled(self) -> bool:
        return any(o is not None and o.device != OffloadDeviceEnum.none
                   for o in (self.offload_param, self.offload_optimizer))
