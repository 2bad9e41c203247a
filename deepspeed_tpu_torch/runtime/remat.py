"""Activation checkpointing (remat) policies — the port of
``deepspeed_tpu/runtime/remat.py``.

The JAX package wraps a block in ``jax.checkpoint`` with a policy chosen
from the model's ``remat_policy`` and the ``activation_checkpointing``
config block; here the block runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` and the policy
decides what the forward keeps:

 - ``"full"``: nothing; the backward recomputes the whole block;
 - ``"dots"``: the outputs of the non-batched matmuls (``aten.mm`` /
   ``aten.addmm``: the block's projections, JAX's
   ``dots_with_no_batch_dims_saveable``); attention and the elementwise
   ops are recomputed;
 - ``"dots_flash"``: those, and the flash forward's o and lse (the op
   ``deepspeed_tpu_torch::flash_attention_fwd``, JAX's ``checkpoint_name``
   ``"flash_out"`` / ``"flash_lse"``), so the backward does not launch the
   forward kernel again.  JAX's v2 kernel (S <= 1024) saves o only and
   recomputes the row statistics in its backward; the port's dq kernel
   reads the lse, so both are saved.

A policy other than full runs the block under two dispatch modes that the
checkpoint's ``context_fn`` installs: the forward's records each saved
op's outputs, the recompute's hands them back in the same order instead
of running the op.  Autograd sits above both, so the recompute still
builds the graph the backward needs.  (A ctypes launch inside an
``autograd.Function`` would be invisible to the modes: the flash forward
is a registered op for that reason.)

``offload`` (the block's ``cpu_checkpointing``, XLA's
``offload_dot_with_no_batch_dims``): the recorded outputs are copied to
page-locked host memory as they are made and copied back when the
recompute asks for them, so between the forward and the backward they
hold no device memory.  It is honoured on one device, as in JAX.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

POLICIES = ("full", "dots", "dots_flash")

#: bytes the offloading policies copied to the host (all calls), for the
#: tests and ``chip_smoke.py``
OFFLOAD_STATS = {"bytes": 0, "tensors": 0}


def check_policy(policy: Optional[str]) -> str:
    """``policy`` resolved (None is "full"); raises on an unknown name."""
    policy = policy or "full"
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} "
                         "(expected full|dots|dots_flash)")
    return policy


def saved_ops(policy: str) -> frozenset:
    """The ops whose outputs ``policy`` keeps from the forward."""
    policy = check_policy(policy)
    if policy == "full":
        return frozenset()
    ops = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    if policy == "dots_flash":
        from ..ops import flash_attention  # registers the op

        ops.add(flash_attention.flash_fwd_op)
    return frozenset(ops)


class _Record(TorchDispatchMode):
    """The forward's mode: run every op, and keep the outputs of the saved
    ones (on the host with ``offload``)."""

    def __init__(self, ops, store, offload: bool):
        super().__init__()
        self.ops, self.store, self.offload = ops, store, offload

    def _keep(self, t: torch.Tensor):
        t = t.detach()
        if not self.offload:
            return t, t._version
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        OFFLOAD_STATS["bytes"] += t.numel() * t.element_size()
        OFFLOAD_STATS["tensors"] += 1
        return host, t.device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            # a saved op returns a tensor (mm) or a tuple of them (flash)
            many = isinstance(out, (tuple, list))
            self.store.append((many, [self._keep(t) for t in
                                      (out if many else (out,))]))
        return out


class _Replay(TorchDispatchMode):
    """The recompute's mode: the saved ops' outputs come back from the
    store, in the forward's order; every other op runs again."""

    def __init__(self, ops, store, offload: bool):
        super().__init__()
        self.ops, self.store, self.offload = ops, store, offload

    def _give(self, kept):
        t, tag = kept
        if self.offload:
            return t.to(tag, non_blocking=True)
        if t._version != tag:
            raise RuntimeError("remat: a saved matmul output was modified "
                               "in place after the forward used it")
        return t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        if not self.store:
            raise RuntimeError(f"remat: {func} ran more often in the "
                               "recompute than in the forward")
        many, kept = self.store.popleft()
        outs = tuple(self._give(k) for k in kept)
        return outs if many else outs[0]


def _contexts(ops, offload: bool):
    store: collections.deque = collections.deque()
    return _Record(ops, store, offload), _Replay(ops, store, offload)


def checkpoint_block(fn: Callable, *args, policy: Optional[str] = "full",
                     offload: bool = False):
    """``fn(*args)`` with its activations recomputed in the backward,
    keeping what ``policy`` saves (module docstring).  The randomness a
    block draws (dropout) comes from explicit keys, so the RNG state is not
    stashed."""
    from torch.utils.checkpoint import checkpoint

    ops = saved_ops(policy)
    if not ops:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, ops, offload))


def apply_config_to_model(ac_config, model, log=None,
                          n_devices: int = 1) -> bool:
    """Apply an ``activation_checkpointing`` config block to a model
    (``remat.py::apply_config_to_model``): any set key switches the
    model config's ``remat`` on; ``policy`` sets ``remat_policy`` where the
    config has one (GPT-2: llama's and Mixtral's remat is full, as JAX's)
    and ``cpu_checkpointing`` sets ``remat_offload``.  Returns True when
    the knobs were switched."""
    requested = (ac_config.enabled or ac_config.partition_activations
                 or ac_config.cpu_checkpointing
                 or ac_config.policy is not None
                 or ac_config.number_checkpoints is not None)
    if not requested:
        return False
    mc = getattr(model, "model_config", None)
    if mc is None or not hasattr(mc, "remat"):
        if log is not None:
            log("activation_checkpointing is configured but the model does "
                "not expose remat knobs (model_config); ignoring")
        return False
    mc.remat = True
    if ac_config.policy is not None and hasattr(mc, "remat_policy"):
        mc.remat_policy = check_policy(ac_config.policy)
    if ac_config.cpu_checkpointing:
        if n_devices > 1:
            if log is not None:
                log("activation_checkpointing.cpu_checkpointing: host "
                    "offload is single-device only; keeping remat WITHOUT "
                    f"host offload on {n_devices} devices")
        else:
            mc.remat_offload = True
    if log is not None:
        log(f"activation checkpointing: remat=True "
            f"policy={getattr(mc, 'remat_policy', 'full')} "
            f"cpu_offload={ac_config.cpu_checkpointing}")
    return True
