"""The training engine — the PyTorch port of
``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``) on one GPU at
ZeRO stage 0.

The user contract is the JAX package's: ``initialize(model, config)``
returns the engine, then either ``engine.train_batch(batch)`` (all
gradient-accumulation micro-batches and the update) or the reference
micro-step loop ``loss = engine(batch); engine.backward(loss);
engine.step()``.

What one ``train_batch`` does (``engine.py:923-962`` and ``:866-895``):
 - the master weights are float32; each micro-batch casts them to the
   compute dtype (bf16 with ``"bf16": {"enabled": true}``) inside the
   differentiated function, so autograd returns float32 gradients, as
   ``_micro_loss_closure`` does under ``jax.value_and_grad``;
 - gradients are summed over the micro-batches and multiplied by
   ``1 / gradient_accumulation_steps``; the reported loss is the mean;
 - ``grad_norm`` is the global norm before clipping; ``gradient_clipping``
   then scales by ``max_norm / norm`` when the norm reaches it;
 - Adam/AdamW (``ops/optimizers.py``) steps the float32 masters in place,
   reading the LR schedule at the number of updates already applied.

Unported features (fp16 and its loss scaler, ZeRO >= 1, offload, meshes,
activation checkpointing, curriculum, random-LTD, compression, sparse
gradients, 1-bit optimizers, the flops profiler, monitors, the pipeline
engine, checkpoints) raise ``NotImplementedError``, from the config
(``runtime/config.py``), the model config or here.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..accelerator import resolve_device
from ..ops.optimizers import (FusedAdam, clip_by_global_norm, get_optimizer,
                              global_norm)
from ..utils.logging import log_dist
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                           STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .lr_schedules import LRScheduler, get_lr_schedule

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _flatten(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, prefix + (k,))]
    return [(prefix, tree)]


def _unflatten(paths, leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _map(fn, batch):
    """``fn`` over the leaves of a dict / tuple / list batch."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _first_leaf(batch):
    while isinstance(batch, (dict, tuple, list)):
        batch = next(iter(batch.values())) if isinstance(batch, dict) \
            else batch[0]
    return batch


class _LazyMetrics(dict):
    """Step metrics whose device values are read on first access (the
    JAX engine's ``_LazyMetrics``): a step does not wait for the device
    unless someone looks."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, torch.Tensor):
            value = value.item()
            super().__setitem__(key, value)
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default


class DeepSpeedEngine:
    """Holds the float32 master parameters, the optimizer state and the
    step counters of one training run."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config: Optional[Union[str, dict]] = None,
                 device=None):
        if model is None or not hasattr(model, "loss_fn"):
            raise TypeError("initialize needs a deepspeed_tpu_torch model "
                            "(models.gpt2.build or models.llama.build)")
        if mpu is not None:
            raise NotImplementedError(
                "mpu: model parallelism comes with the PyTorch port's "
                "multi-GPU slice (ROADMAP.md)")
        self._config = DeepSpeedConfig(config if config is not None else {})
        self.device = resolve_device(device)
        self.module = model
        self.client_optimizer = optimizer
        self.client_lr_scheduler = lr_scheduler
        self.collate_fn = collate_fn

        self.global_steps = 0
        self.micro_steps = 0
        self._cached_metrics: Dict[str, Any] = {}

        self.compute_dtype = _DTYPES[self._config.precision_dtype]

        self._configure_lr_schedule()
        self._configure_optimizer()

        # float32 master weights: the caller's (model_parameters, e.g.
        # gpt2.params_from_jax), copied, or the model's init from the config
        # seed, drawn on the engine's device (llama: a leaf at a time) and
        # kept without a copy
        seed = self._config.seed or 42
        drawn = model_parameters is None
        if drawn:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model_parameters = model.init_fn(gen)
        flat = _flatten(model_parameters)
        self._paths = [path for path, _ in flat]
        self._leaves: List[torch.Tensor] = []
        for _, leaf in flat:
            t = torch.as_tensor(np.asarray(leaf) if not
                                isinstance(leaf, torch.Tensor) else leaf)
            if t.is_floating_point():
                t = t.to(torch.float32)
            t = t.to(self.device).detach()
            if not drawn:
                t = t.clone()
            self._leaves.append(t.requires_grad_(t.is_floating_point()))
        self._params = _unflatten(self._paths, self._leaves)
        self._opt_state = self.optimizer.init(self._leaves)
        n = sum(t.numel() for t in self._leaves)
        log_dist(f"initialized {n / 1e6:.2f}M parameters", ranks=[0])

        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None
        self._data_iterator: Optional[Iterator] = None

        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self._config.steps_per_print or 10,
            device=self.device)
        self.wall_clock_breakdown_enabled = self._config.wall_clock_breakdown
        self._accum_losses: List[torch.Tensor] = []
        log_dist(
            f"DeepSpeedEngine: device={self.device}, zero_stage=0, "
            f"dtype={self._config.precision_dtype}, "
            f"micro_bs={self.train_micro_batch_size_per_gpu()}, "
            f"gas={self.gradient_accumulation_steps()}, "
            f"global_bs={self.train_batch_size()}", ranks=[0])

    # ------------------------------------------------------------------ config
    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def steps_per_print(self) -> int:
        return self._config.steps_per_print

    def get_lr(self) -> List[float]:
        """The learning rate of the next update."""
        return [self.optimizer.lr_at(self.global_steps)]

    def get_global_grad_norm(self) -> Optional[float]:
        gn = self._cached_metrics.get("grad_norm")
        return float(gn) if gn is not None else None

    # --------------------------------------------------------------- optimizer
    def _configure_lr_schedule(self) -> None:
        if callable(self.client_lr_scheduler):
            self.lr_schedule = self.client_lr_scheduler
        elif self._config.scheduler_name:
            self.lr_schedule = get_lr_schedule(
                self._config.scheduler_name,
                self._config.scheduler_params or {})
        else:
            self.lr_schedule = None
        self.lr_scheduler = (LRScheduler(self.lr_schedule)
                             if self.lr_schedule is not None else None)

    def _configure_optimizer(self) -> None:
        if self.client_optimizer is not None:
            if not isinstance(self.client_optimizer, FusedAdam):
                raise NotImplementedError(
                    f"client optimizer {type(self.client_optimizer).__name__}"
                    ": the PyTorch port takes an ops.optimizers.FusedAdam "
                    "(Adam/AdamW) so far")
            self.optimizer = self.client_optimizer
        else:
            self.optimizer = get_optimizer(
                self._config.optimizer_name or "adam",
                self._config.optimizer_params or {},
                lr_schedule=self.lr_schedule)

    # ------------------------------------------------------------------- state
    @property
    def params(self) -> Dict[str, Any]:
        """The float32 master parameters, a nested dict of tensors."""
        return self._params

    @property
    def state(self) -> Dict[str, Any]:
        return {"step": self.global_steps, "params": self._params,
                "opt_state": self._opt_state}

    # ---------------------------------------------------------------- batching
    def _to_device(self, batch):
        def move(x):
            t = x if isinstance(x, torch.Tensor) else \
                torch.as_tensor(np.asarray(x))
            if not t.is_floating_point():
                t = t.to(torch.int64)
            return t.to(self.device)

        return _map(move, batch)

    def _micro_batches(self, batch) -> List[Any]:
        """A global batch as ``gas`` micro-batches: leaves with leading dim
        ``train_batch_size`` are split into ``[gas, micro]``
        (``_reshape_global_batch``, ``engine.py:1197``); leaves already
        shaped ``[gas, micro, ...]`` are indexed along their first dim."""
        gas = self.gradient_accumulation_steps()
        mb = self.train_micro_batch_size_per_gpu()
        lead = len(_first_leaf(batch))
        if lead == self.train_batch_size():
            batch = _map(lambda x: x.reshape((gas, mb) + tuple(x.shape[1:])),
                         _map(lambda x: x if isinstance(x, torch.Tensor)
                              else np.asarray(x), batch))
        elif lead != gas:
            raise ValueError(
                f"train_batch expects a global batch of {self.train_batch_size()}"
                f" rows or [{gas}, {mb}, ...], got leading dim {lead}")
        return [_map(lambda x, i=i: x[i], batch) for i in range(gas)]

    # ------------------------------------------------------------------- train
    def _micro_loss(self, micro):
        """Loss of one micro-batch with the masters cast to the compute
        dtype inside the autograd graph."""
        params = self._params
        if self.compute_dtype != torch.float32:
            params = _unflatten(self._paths, [
                p.to(self.compute_dtype) if p.is_floating_point() else p
                for p in self._leaves])
        return self.module.loss_fn(params, self._to_device(micro), None, True)

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self._leaves]

    def _apply_update(self, grads: List[torch.Tensor], mean_loss):
        """grads: float32, averaged over the global batch."""
        grad_norm = global_norm(grads)
        if self._config.gradient_clipping:
            clip_by_global_norm(grads, self._config.gradient_clipping,
                                grad_norm)
        lr = self.optimizer.step(self._leaves, grads, self._opt_state)
        for p in self._leaves:
            p.grad = None
        return {"loss": mean_loss, "grad_norm": grad_norm, "lr": lr}

    def train_batch(self, batch=None, data_iter=None):
        """One global step: every micro-batch's forward and backward, then
        the update.  ``batch`` has ``train_batch_size`` rows (or is already
        ``[gas, micro, ...]``); without it, ``gas`` micro-batches come from
        ``data_iter`` or the training dataloader.  Returns ``(state,
        metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            it = data_iter or self._ensure_data_iterator()
            micros = [next(it) for _ in range(gas)]
        else:
            micros = self._micro_batches(batch)
        self.tput_timer.start()
        self.timers(TRAIN_BATCH_TIMER).start()
        loss_sum = None
        for micro in micros:
            loss = self._micro_loss(micro)
            loss.backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = self._grads()
        if gas > 1:
            torch._foreach_mul_(grads, 1.0 / gas)
        metrics = self._apply_update(grads, loss_sum / gas)
        self.global_steps += 1
        self.micro_steps += gas
        self.timers(TRAIN_BATCH_TIMER).stop()
        self.tput_timer.stop(global_step=True, sync=self._report_step())
        self._finalize_metrics(metrics)
        return self.state, self._cached_metrics

    def train_batches(self, batches):
        """Several consecutive ``train_batch`` steps (a list of global
        batches, or one stacked on a leading steps dim); returns the last
        step's ``(state, metrics)``."""
        if not isinstance(batches, (list, tuple)):
            k = len(_first_leaf(batches))
            batches = [_map(lambda x, i=i: x[i], batches) for i in range(k)]
        if not batches:
            raise ValueError("train_batches requires at least one batch")
        for b in batches:
            out = self.train_batch(b)
        return out

    def _report_step(self) -> bool:
        return self.global_steps % max(self.steps_per_print(), 1) == 0

    def _ensure_data_iterator(self):
        if self._data_iterator is None:
            if self.training_dataloader is None:
                raise ValueError("no training_data was passed to "
                                 "initialize() and no batch/data_iter given")
            self._data_iterator = iter(RepeatingLoader(
                self.training_dataloader))
        return self._data_iterator

    def _finalize_metrics(self, metrics) -> None:
        self._cached_metrics = _LazyMetrics(metrics)
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(self.global_steps)
        if self._report_step():
            log_dist(f"step={self.global_steps} "
                     f"loss={self._cached_metrics['loss']:.4f} "
                     f"lr={self._cached_metrics['lr']:.3e} "
                     f"grad_norm={self._cached_metrics['grad_norm']:.3f}",
                     ranks=[0])

    # -------------------------------------------- reference micro-step shims
    def forward(self, batch):
        """The micro-batch loss, still attached to the autograd graph for
        ``backward``."""
        if self.wall_clock_breakdown_enabled:
            self.timers(FORWARD_GLOBAL_TIMER).start()
        loss = self._micro_loss(batch)
        if self.wall_clock_breakdown_enabled:
            self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss, allreduce_gradients: bool = True):
        """Accumulate ``loss / gradient_accumulation_steps``'s gradients."""
        if self.wall_clock_breakdown_enabled:
            self.timers(BACKWARD_GLOBAL_TIMER).start()
        (loss.float() / self.gradient_accumulation_steps()).backward()
        self._accum_losses.append(loss.detach().float())
        self.micro_steps += 1
        if self.wall_clock_breakdown_enabled:
            self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """Apply the accumulated update at a GAS boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        if not self._accum_losses:
            raise RuntimeError("step() without accumulated gradients")
        if self.wall_clock_breakdown_enabled:
            self.timers(STEP_GLOBAL_TIMER).start()
        mean_loss = torch.stack(self._accum_losses).mean()
        metrics = self._apply_update(self._grads(), mean_loss)
        self._accum_losses = []
        self.global_steps += 1
        self._finalize_metrics(metrics)
        if self.wall_clock_breakdown_enabled:
            self.timers(STEP_GLOBAL_TIMER).stop()

    # -------------------------------------------------------------------- eval
    @torch.no_grad()
    def eval_batch(self, batch, rng=None):
        """The loss of ``batch`` with the current weights (no update)."""
        params = _unflatten(self._paths, [p.to(self.compute_dtype)
                                          for p in self._leaves])
        return self.module.loss_fn(params, self._to_device(batch), rng,
                                   False)

    # -------------------------------------------------------------------- data
    def deepspeed_io(self, dataset, batch_size: Optional[int] = None,
                     route=None, pin_memory: bool = True, data_sampler=None,
                     collate_fn=None, num_local_io_workers=None
                     ) -> DeepSpeedDataLoader:
        """The framework loader over ``dataset`` (reference
        ``engine.py:318``), yielding micro-batches."""
        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
            collate_fn=collate_fn or self.collate_fn,
            seed=self._config.seed or 0,
            drop_last=self._config.dataloader_drop_last,
            data_sampler=data_sampler)

    # ------------------------------------------------------------- checkpoints
    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "save_checkpoint: checkpoints come with the PyTorch port's "
            "checkpoint slice (ROADMAP.md)")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "load_checkpoint: checkpoints come with the PyTorch port's "
            "checkpoint slice (ROADMAP.md)")
