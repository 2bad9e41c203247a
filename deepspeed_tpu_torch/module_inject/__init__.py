"""module_inject — HuggingFace models into the port's families (the
PyTorch port of ``deepspeed_tpu/module_inject``).

 - :mod:`.replace_policy`: the per-architecture policy registry (HF
   architecture -> config translation, weight conversion, model
   constructor) and ``replace_module``.

The JAX package's ``auto_tp.infer_tp_specs`` (tensor-parallel layouts of
an arbitrary tree) and the families' ``tp_rules`` come with the port's
multi-GPU slice (ROADMAP.md Queue A item 8).
"""

from .replace_policy import (HFPolicy, generic_policies, policy_for,
                             replace_module)

__all__ = ["HFPolicy", "generic_policies", "policy_for", "replace_module"]
