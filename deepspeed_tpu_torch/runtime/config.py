"""Master JSON config — the port's copy of
``deepspeed_tpu/runtime/config.py`` (reference ``DeepSpeedConfig``), with
the same keys, ``"auto"`` values and batch-size triple, on the standard
library.

The port trains on one GPU, so the data-parallel world size is 1: ZeRO
stages 0-3 and the offload tiers (``offload_optimizer`` / ``offload_param``
at ``cpu`` or ``nvme``) are accepted, as the JAX package accepts them on a
one-device mesh.  Keys whose feature is not ported yet (more than one rank
among them) are refused here, each with a ``NotImplementedError`` naming
the slice that brings it, never ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

from . import constants as C
from .config_utils import DeepSpeedConfigModel, Field
from .zero.config import DeepSpeedZeroConfig


class DeepSpeedConfigError(Exception):
    pass


@dataclasses.dataclass(init=False)
class Fp16Config(DeepSpeedConfigModel):
    """The ``fp16`` block (``config.py:34``): ``loss_scale`` 0 is dynamic
    scaling from ``2 ** initial_scale_power``, any other value a static
    scale."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


@dataclasses.dataclass(init=False)
class Bf16Config(DeepSpeedConfigModel):
    enabled: bool = False


@dataclasses.dataclass(init=False)
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """The ``activation_checkpointing`` block (``config.py:49``; reference
    checkpointing.py:749).  Any set key switches the model's remat on
    (``runtime/remat.py``); ``policy`` ("full" | "dots" | "dots_flash")
    picks what is saved; ``cpu_checkpointing`` keeps the saved outputs in
    page-locked host memory.  ``partition_activations``,
    ``contiguous_memory_optimization``, ``number_checkpoints``,
    ``synchronize_checkpoint_boundary`` and ``profile`` are the
    reference's allocator and stream knobs: accepted, as in JAX."""
    enabled: bool = False
    policy: Optional[str] = None
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclasses.dataclass(init=False)
class OptimizerConfigBlock(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)
    legacy_fusion: bool = False


@dataclasses.dataclass(init=False)
class SchedulerConfigBlock(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)


#: "auto"-resolvable keys with hidden-size formulas (``config.py:115``)
_AUTO_HIDDEN_FORMULAS = {
    "reduce_bucket_size": lambda h: h * h,
    "stage3_prefetch_bucket_size": lambda h: int(0.9 * h * h),
    "stage3_param_persistence_threshold": lambda h: 10 * h,
}


def resolve_auto_config(pd: dict, hidden_size: Optional[int] = None) -> dict:
    """Resolve ``"auto"`` values (``config.py:122``): batch-triple keys
    become unset (the triple derivation fills them), ZeRO bucket and
    threshold keys take their hidden-size formula when ``hidden_size`` is
    known, and any other ``"auto"`` is dropped so the default applies."""
    out = {}
    for k, v in pd.items():
        if isinstance(v, dict):
            out[k] = resolve_auto_config(v, hidden_size)
        elif isinstance(v, str) and v == "auto":
            if hidden_size and k in _AUTO_HIDDEN_FORMULAS:
                out[k] = _AUTO_HIDDEN_FORMULAS[k](hidden_size)
        else:
            out[k] = v
    return out


MULTI_GPU = "multi-GPU (Queue A 8)"


def _unported(key: str, slice_name: str):
    raise NotImplementedError(
        f"config {key!r}: not ported yet — it comes with the PyTorch port's "
        f"{slice_name} slice (ROADMAP.md)")


def _refuse_unported(pd: dict, zero: DeepSpeedZeroConfig) -> None:
    """Raise for every enabled feature this port does not have yet."""
    # ZeRO stages 0-3 and the offload tiers run at world size 1 (one GPU),
    # as the JAX package runs them on a one-device mesh; more ranks wait
    for axis, n in (pd.get(C.MESH) or {}).items():
        if int(n) > 1:
            _unported(f"mesh.{axis}={n}", MULTI_GPU)
    if pd.get(C.CURRICULUM_LEARNING_LEGACY, {}).get("enabled", False):
        _unported("curriculum_learning", "data-efficiency")
    de = pd.get(C.DATA_EFFICIENCY, {})
    if de.get("data_sampling", {}).get("curriculum_learning", {}).get(
            "enabled", False):
        _unported("data_efficiency.data_sampling.curriculum_learning",
                  "data-efficiency")
    if de.get("data_routing", {}).get("random_ltd", {}).get("enabled", False):
        _unported("data_efficiency.data_routing.random_ltd",
                  "data-efficiency")
    if pd.get(C.COMPRESSION_TRAINING):
        _unported("compression_training", "compression")
    if pd.get(C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT):
        _unported("sparse_gradients", MULTI_GPU)
    if pd.get(C.FLOPS_PROFILER, {}).get("enabled", False):
        _unported("flops_profiler", "telemetry")
    for key in C.MONITORS:
        if pd.get(key, {}).get("enabled", False):
            _unported(key, "telemetry")
    if pd.get(C.PIPELINE):
        _unported("pipeline", MULTI_GPU)
    if pd.get(C.ELASTICITY, {}).get("enabled", False):
        _unported("elasticity", MULTI_GPU)
    opt = (pd.get(C.OPTIMIZER) or {}).get(C.TYPE)
    if opt is not None:
        name = str(opt).lower()
        if name in C.ONEBIT_OPTIMIZERS:
            _unported(f"optimizer {opt!r}", "multi-GPU (1-bit optimizers, "
                      "Queue A 8)")
        offloaded = zero.offload_optimizer is not None and \
            zero.offload_optimizer.device != "none"
        if name not in C.PORTED_OPTIMIZERS and not (
                offloaded and name in C.OFFLOAD_OPTIMIZERS):
            raise NotImplementedError(
                f"optimizer {opt!r}: the PyTorch port runs "
                f"{C.PORTED_OPTIMIZERS} on the device, and "
                f"{C.OFFLOAD_OPTIMIZERS} with "
                "zero_optimization.offload_optimizer (the host C++ step)")


class DeepSpeedConfig:
    """Parsed and validated master config (``config.py:149``) for one
    GPU."""

    def __init__(self, config: Union[str, dict]):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(
                    f"config path does not exist: {config}")
            with open(config) as f:
                config = json.load(f)
        elif not isinstance(config, dict):
            raise DeepSpeedConfigError(
                f"expected a dict or json path, got {type(config)}")
        self._param_dict = resolve_auto_config(config)
        self.world_size = 1          # data-parallel world: one GPU
        self._initialize_params(self._param_dict)
        _refuse_unported(self._param_dict, self.zero_config)
        self._configure_train_batch_size()
        self._batch_assertion()

    def _initialize_params(self, pd: dict) -> None:
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE,
                                       C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT,
                                      C.STEPS_PER_PRINT_DEFAULT)
        self.seed = pd.get(C.SEED, C.SEED_DEFAULT)

        self.zero_config = DeepSpeedZeroConfig(
            **pd.get(C.ZERO_OPTIMIZATION, {}))

        self.fp16_config = Fp16Config(**pd.get(C.FP16, {}))
        self.fp16_enabled = bool(self.fp16_config.enabled)
        self.bf16_config = Bf16Config(
            **pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {})))
        self.bfloat16_enabled = bool(self.bf16_config.enabled)
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self.precision_dtype = ("float16" if self.fp16_enabled else
                                "bfloat16" if self.bfloat16_enabled
                                else "float32")
        self.loss_scale = self.fp16_config.loss_scale
        self.dynamic_loss_scale_args = {
            "init_scale": 2**self.fp16_config.initial_scale_power,
            "scale_window": self.fp16_config.loss_scale_window,
            "min_scale": self.fp16_config.min_loss_scale,
            "delayed_shift": self.fp16_config.hysteresis,
        }
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            **pd.get(C.ACTIVATION_CHECKPOINTING, {}))

        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING,
                                        C.GRADIENT_CLIPPING_DEFAULT)
        self.wall_clock_breakdown = pd.get(C.WALL_CLOCK_BREAKDOWN,
                                           C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.dataloader_drop_last = pd.get(C.DATALOADER_DROP_LAST,
                                           C.DATALOADER_DROP_LAST_DEFAULT)

        opt_block = pd.get(C.OPTIMIZER)
        self.optimizer_config = (OptimizerConfigBlock(**opt_block)
                                 if opt_block else None)
        self.optimizer_name = (self.optimizer_config.type.lower()
                               if self.optimizer_config
                               and self.optimizer_config.type else None)
        self.optimizer_params = (self.optimizer_config.params
                                 if self.optimizer_config else None)

        sched_block = pd.get(C.SCHEDULER)
        self.scheduler_config = (SchedulerConfigBlock(**sched_block)
                                 if sched_block else None)
        self.scheduler_name = (self.scheduler_config.type
                               if self.scheduler_config else None)
        self.scheduler_params = (self.scheduler_config.params
                                 if self.scheduler_config else None)

    # -- batch-size triple (``config.py:361-405``) ----------------------------
    def _configure_train_batch_size(self) -> None:
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        ws = self.world_size

        have = (train is not None, micro is not None, gas is not None)
        if all(have):
            pass
        elif have == (True, True, False):
            gas = train // micro
            gas //= ws
        elif have == (True, False, True):
            micro = train // ws
            micro //= gas
        elif have == (False, True, True):
            train = micro * gas * ws
        elif have == (True, False, False):
            gas = 1
            micro = train // ws
        elif have == (False, True, False):
            gas = 1
            train = micro * ws
        elif have == (False, False, True):
            micro = 1
            train = gas * ws
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size / "
                "train_micro_batch_size_per_gpu / gradient_accumulation_steps "
                "must be set")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    def _batch_assertion(self) -> None:
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        for name, value in (("Train batch size", train),
                            ("Micro batch size per gpu", micro),
                            ("Gradient accumulation steps", gas)):
            if value <= 0:
                raise DeepSpeedConfigError(
                    f"{name}: {value} has to be greater than 0")
        if train != micro * gas * self.world_size:
            raise DeepSpeedConfigError(
                "Check batch related parameters. train_batch_size is not "
                "equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {train} != {micro} * {gas} * {self.world_size}")
