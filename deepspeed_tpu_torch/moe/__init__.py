"""Mixture of experts: gating, capacity-bucket dispatch / combine and the
functional MoE layer (``deepspeed_tpu/moe``)."""

from .layer import MoEConfig, init_moe_params, moe_apply
from .sharded_moe import top1gating, top2gating

__all__ = ["MoEConfig", "init_moe_params", "moe_apply", "top1gating",
           "top2gating"]
