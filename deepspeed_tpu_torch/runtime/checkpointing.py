"""Checkpoint save/load — the port's copy of
``deepspeed_tpu/runtime/checkpointing.py`` (reference ``engine.py:3068
save_checkpoint`` / ``:2708 load_checkpoint`` and the tag protocol).

Layout, the JAX package's::

    <save_dir>/
      latest                          # the newest tag
      <tag>/                          # default tag: global_step{N}
        ds_meta.json                  # counters, lr schedule, client_state
        state/model_states.pt         # torch.save: the float32 params and
                                      # the resident optimizer's buffers,
                                      # each a dict by leaf name, and the
                                      # fp16 loss scaler
        offload_optimizer.p0.npz      # np.savez of the host optimizer's
                                      # state_dict (offload)
        offload_blocks.npz            # the same for the streamed blocks

``state/`` holds the port's own file where the JAX package writes an orbax
tree (orbax is not installed with the port); its leaves carry orbax's
names, the path joined by ``.`` with list indices as numbers
(:func:`leaf_name`: ``down.0.resnets.1.conv1.w``).  Under offload the float32
masters are the host optimizer's, saved once in its ``.npz``, and
``model_states.pt`` holds no params.  The loss scaler is saved under
``"scaler"`` with JAX's ``LossScaleState`` field names (``cur_scale``,
``cur_hysteresis``, ``good_steps``, ``skipped``; ``checkpointing.py:17,
:204``), so an fp16 run resumes at its scale.  One rank writes everything
(``process_index`` 0 of the JAX names); tag validation across processes
comes with more ranks (``ROADMAP.md`` Queue A 8).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.optimizers import state_buffers
from ..utils.logging import log_dist, logger
from .fp16.loss_scaler import FIELDS as SCALER_FIELDS

#: the one process's index in the JAX file names
_PROCESS = 0


def leaf_name(path) -> str:
    """A leaf's name in a checkpoint: its path joined by ``.``, list
    indices as numbers (orbax's parameter names in the JAX engine's
    ``state/``, ``params.`` prefix dropped: ``down.0.resnets.1.conv1.w``)."""
    return ".".join(str(k) for k in path)


class CheckpointManager:
    """Engine-facing checkpoint orchestration with the reference's tag
    protocol."""

    def __init__(self, engine):
        self.engine = engine

    @staticmethod
    def _dir(path) -> str:
        if path is None:
            raise ValueError("save_checkpoint/load_checkpoint need a "
                             "directory")
        return str(path)

    def save(self, save_dir: str, tag: Optional[str] = None,
             client_state: Optional[Dict[str, Any]] = None,
             save_latest: bool = True) -> str:
        engine = self.engine
        save_dir = self._dir(save_dir)
        if tag is None:
            tag = f"global_step{engine.global_steps}"
        ckpt_dir = os.path.join(save_dir, str(tag))
        os.makedirs(os.path.join(ckpt_dir, "state"), exist_ok=True)

        scaler = {name: getattr(engine._scaler, name).detach().cpu()
                  for name in SCALER_FIELDS}
        if engine.offload_enabled:
            state = {"step": engine.global_steps, "params": None,
                     "opt_state": None, "scaler": scaler}
            np.savez(os.path.join(ckpt_dir,
                                  f"offload_optimizer.p{_PROCESS}.npz"),
                     **engine._offload_opt.state_dict())
            if engine._block_opt is not None:
                np.savez(os.path.join(ckpt_dir, "offload_blocks.npz"),
                         **engine._block_opt.state_dict())
        else:
            opt = engine._opt_state
            names = [leaf_name(p) for p in engine._paths]

            def named(tensors):
                return {n: t.detach().cpu() for n, t in zip(names, tensors)}

            state = {"step": engine.global_steps,
                     "params": named(engine._leaves),
                     "opt_state": {"count": opt.count, **{
                         name: named(getattr(opt, name))
                         for name in state_buffers(opt)}},
                     "scaler": scaler}
        torch.save(state, os.path.join(ckpt_dir, "state", "model_states.pt"))
        meta = {
            "tag": str(tag),
            "global_steps": engine.global_steps,
            "global_samples": engine.global_samples,
            "micro_steps": engine.micro_steps,
            "skipped_steps": engine.skipped_steps,
            "dp_world_size": 1,
            "mesh": {"pp": 1, "dp": 1, "ep": 1, "sp": 1, "tp": 1},
            "zero_stage": engine.zero_stage,
            "dtype": engine._config.precision_dtype,
            "lr_scheduler": (engine.lr_scheduler.state_dict()
                             if engine.lr_scheduler else None),
            "client_state": client_state or {},
        }
        with open(os.path.join(ckpt_dir, "ds_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        if save_latest:
            with open(os.path.join(save_dir, "latest"), "w") as f:
                f.write(str(tag))
        log_dist(f"saved checkpoint {ckpt_dir}", ranks=[0])
        return ckpt_dir

    def load(self, load_dir: str, tag: Optional[str] = None,
             load_optimizer_states: bool = True,
             load_module_only: bool = False):
        engine = self.engine
        load_dir = self._dir(load_dir)
        if tag is None:
            latest_path = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest_path):
                logger.warning(f"no 'latest' file at {load_dir}; nothing "
                               "loaded")
                return None, {}
            with open(latest_path) as f:
                tag = f.read().strip()
        ckpt_dir = os.path.join(load_dir, str(tag))
        meta: Dict[str, Any] = {}
        meta_path = os.path.join(ckpt_dir, "ds_meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        full = load_optimizer_states and not load_module_only
        state = torch.load(os.path.join(ckpt_dir, "state", "model_states.pt"))

        if engine.offload_enabled:
            path = os.path.join(ckpt_dir, f"offload_optimizer.p{_PROCESS}.npz")
            with np.load(path) as z:
                sd = dict(z)
            if full:
                engine._offload_opt.load_state_dict(sd)
            else:
                # the masters only: fresh moments and step counts, as the
                # resident engine keeps its optimizer state
                engine._offload_opt.master[:] = sd["master"]
            self._refresh_device_copy()
            blk_path = os.path.join(ckpt_dir, "offload_blocks.npz")
            if engine._block_opt is not None and os.path.isfile(blk_path):
                with np.load(blk_path) as z:
                    sd = dict(z)
                if full:
                    engine._block_opt.load_state_dict(sd)
                else:
                    engine._block_opt.master[:] = sd["master"]
                engine._param_store.refresh_compute()
        else:
            names = [leaf_name(p) for p in engine._paths]
            if set(state["params"]) != set(names):
                raise ValueError(
                    f"checkpoint {ckpt_dir} holds other leaves than this "
                    f"model: missing {sorted(set(names) - set(state['params']))[:4]}"
                    f", unexpected {sorted(set(state['params']) - set(names))[:4]}")
            with torch.no_grad():
                for leaf, name in zip(engine._leaves, names):
                    leaf.copy_(state["params"][name])
            if full:
                opt = engine._opt_state
                opt.count = int(state["opt_state"]["count"])
                for buf in state_buffers(opt):
                    saved = state["opt_state"][buf]
                    for dst, name in zip(getattr(opt, buf), names):
                        dst.copy_(saved[name])
        if full and state.get("scaler") is not None:
            with torch.no_grad():
                for name in SCALER_FIELDS:
                    getattr(engine._scaler, name).copy_(state["scaler"][name])

        engine.global_steps = int(meta.get("global_steps", 0))
        engine.global_samples = int(meta.get("global_samples", 0))
        engine.micro_steps = int(meta.get("micro_steps", 0))
        engine.skipped_steps = int(meta.get("skipped_steps", 0))
        if engine.lr_scheduler is not None and meta.get("lr_scheduler"):
            engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        log_dist(f"loaded checkpoint {ckpt_dir} at step "
                 f"{engine.global_steps}", ranks=[0])
        return ckpt_dir, meta.get("client_state", {})

    def _refresh_device_copy(self, chunk: int = 1 << 24) -> None:
        """The device's compute copy from the host masters, a chunk at a
        time (the cast runs where the copy lands)."""
        engine = self.engine
        master = torch.from_numpy(engine._offload_opt.master)
        with torch.no_grad():
            for s in range(0, master.numel(), chunk):
                e = min(s + chunk, master.numel())
                engine._dev_flat[s:e].copy_(
                    master[s:e].to(engine.device, non_blocking=False))
