"""The training engine — the PyTorch port of
``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``) on one GPU, at
ZeRO stages 0-3 (one rank holds the whole partition) with the offload
tiers.

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

ZeRO-Offload (``zero_optimization.offload_optimizer``, ``engine.py:745,
973, 1436-1520``): the device holds the weights in the compute dtype only
(the leaves of one flat buffer) and one flat float32 gradient
accumulator; each micro-step's gradient of a leaf is folded into it as
autograd completes it (``register_post_accumulate_grad_hook``), so the
gradients of the whole model never exist in the compute dtype at once.
The mean, the global norm and the clip (``min(1, clip / (norm + 1e-6))``,
the JAX offload path's) run on the device; the float32 masters and the
moments live on the host (``runtime/zero/offload.py``, ``device`` ``cpu``
or ``nvme``), where the C++ Adam/Adagrad steps them piece by piece while
the gradients stream in and the updated weights (bf16 written by the same
pass) stream back through a ring of pinned slots
(``offload.DeviceRing``).  The LR is read at the host optimizer's applied
steps.  ZeRO-Infinity parameter streaming (``offload_param``,
``engine.py:605-800``): the stacked blocks live on the host
(``runtime/zero/param_stream.py``), each layer loaded for its forward and
again for its backward; the host clip covers the resident and streamed
gradients together.

fp16 (``"fp16": {"enabled": true}``, ``engine.py:821-1000``): the
weights are cast to float16 inside the differentiated function, the loss
is multiplied by the loss scale, the float32 gradients by ``1 / (gas x
scale)``; ``overflow`` (any inf or NaN gradient) is computed before the
clip, an overflowing step applies no update and does not advance the LR
schedule, and the scaler (``runtime/fp16/loss_scaler.py``, four device
tensors) advances either way.  The scaler and the flag stay on the
device; the one read of a step is the flag that decides whether the
optimizer runs (``lax.cond`` in JAX; its offload path reads it too).
Metrics add ``overflow``, ``loss_scale`` and ``skipped``.

Attention dropout: each micro-step's loss gets the key ``fold_in(fold_in(
PRNGKey(seed + 1), step), micro)`` (``engine.py:353, :927, :934``), a
JAX-layout threefry key (``ops/sampling.py``); the model folds in the
layer.  ``activation_checkpointing`` switches the model's remat on
(``runtime/remat.py``).

Checkpoints (``save_checkpoint`` / ``load_checkpoint``,
``runtime/checkpointing.py``) keep the JAX layout.

Unported features (more than one rank, curriculum, random-LTD,
compression, sparse gradients, 1-bit optimizers, the flops profiler,
monitors, the pipeline engine) raise ``NotImplementedError``, from the
config (``runtime/config.py``), the model config or here.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..accelerator import resolve_device
from ..ops import cpu_adam
from ..ops.optimizers import (Optimizer, clip_by_global_norm, get_optimizer,
                              global_norm)
from ..ops.sampling import fold_in_words
from ..utils.logging import log_dist
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                           STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from .checkpointing import CheckpointManager
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import LossScaleState, has_overflow, update_scale
from .lr_schedules import LRScheduler, get_lr_schedule
from .remat import apply_config_to_model

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _flatten(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of a tree of dicts and lists, in insertion
    order: a dict's entries keyed by their names, a list's by their int
    indices (the JAX pytree's ``DictKey`` / ``SequenceKey``; the VAE and
    UNet keep their blocks in lists)."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, prefix + (k,))]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def _lists(node):
    """Nodes keyed by ints ``0..n-1`` back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _unflatten(paths, leaves) -> Dict[str, Any]:
    """The tree of :func:`_flatten`'s paths: int path entries make
    lists."""
    out: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _lists(out)


def _map(fn, batch):
    """``fn`` over the leaves of a dict / tuple / list batch."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def batch_to_device(batch, device):
    """Every leaf of a dict / tuple / list batch on ``device``: integers as
    int64, floats in the caller's dtype (a float64 array as float32, as
    ``jnp.asarray`` makes it with x64 off).  The JAX engines cast no batch
    (``engine.py:1181``, ``inference/engine.py:347``), and the
    convolutional families compute in their input's dtype."""
    def move(x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        elif t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(device)

    return _map(move, batch)


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
                            "with a loss_fn (models.<family>.build or "
                            "models.get_model)")
        if mpu is not None:
            raise NotImplementedError(
                "mpu: model parallelism comes with the PyTorch port's "
                "multi-GPU slice (ROADMAP.md Queue A 8)")
        self._config = DeepSpeedConfig(config if config is not None else {})
        self.device = resolve_device(device)
        self.module = model
        self.client_optimizer = optimizer
        self.client_lr_scheduler = lr_scheduler
        self.collate_fn = collate_fn

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._cached_metrics: Dict[str, Any] = {}

        self.compute_dtype = _DTYPES[self._config.precision_dtype]
        self.fp16_enabled = self._config.fp16_enabled
        self.dynamic_loss_scale = self.fp16_enabled and \
            self._config.loss_scale == 0
        self._scaler = self._scaler_init()
        seed = self._config.seed or 42
        # PRNGKey(seed + 1) as its two uint32 words (ops/sampling.py)
        self._dropout_rng = (0, (seed + 1) & 0xFFFFFFFF)
        # activation_checkpointing -> the model's remat knobs (engine.py:242)
        apply_config_to_model(self._config.activation_checkpointing_config,
                              model, log=lambda m: log_dist(m, ranks=[0]))

        # ZeRO at world size 1 and its offload tiers (engine.py:190-232)
        zc = self._config.zero_config
        self.zero_stage = int(zc.stage)
        off = zc.offload_optimizer
        self.offload_enabled = off is not None and off.device != "none"
        if self.offload_enabled and optimizer is not None:
            raise ValueError(
                "offload_optimizer requires a config-specified optimizer "
                "(adam/adamw/adagrad) — client optax transformations cannot "
                "run on host (reference: offload needs DeepSpeedCPUAdam)")
        offp = zc.offload_param
        self.param_stream_enabled = offp is not None and \
            offp.device != "none"
        self._offload_opt = None
        self._param_store = None
        self._block_opt = None
        if self.param_stream_enabled:
            if not self.offload_enabled:
                raise ValueError(
                    "offload_param requires offload_optimizer too: streamed "
                    "block gradients are accumulated on host and must be "
                    "stepped by the host optimizer (reference ZeRO-Infinity "
                    "couples param+optimizer NVMe tiers, zero/stage3.py:486)")
            hooks = getattr(model, "pipeline_hooks", None)
            if hooks is None:
                raise ValueError(
                    "offload_param needs a block-structured model "
                    "(ModelSpec.pipeline_hooks) so layers can stream "
                    "one scan step at a time")
            if float(hooks.get("dropout", 0.0) or 0.0) > 0.0:
                raise ValueError(
                    "offload_param does not support dropout yet (the "
                    "streamed block vjp would need the rng threaded through "
                    "its residuals); set dropout=0")

        self._configure_lr_schedule()
        if not self.offload_enabled:
            self._configure_optimizer()

        # float32 master weights: the caller's (model_parameters, e.g.
        # gpt2.params_from_jax), copied, or the model's init from the config
        # seed, drawn on the engine's device (llama: a leaf at a time) and
        # kept without a copy
        drawn = model_parameters is None
        if drawn:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model_parameters = model.init_fn(gen)
        if self.offload_enabled:
            flat = _flatten(model_parameters)
            del model_parameters
            self._init_offload(flat)
        else:
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
        self.checkpoint_manager = CheckpointManager(self)
        log_dist(
            f"DeepSpeedEngine: device={self.device}, "
            f"zero_stage={self.zero_stage}, offload="
            f"{off.device.value if self.offload_enabled else 'none'}, "
            f"param_stream={self.param_stream_enabled}, "
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

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def get_lr(self) -> List[float]:
        """The learning rate of the next update (the schedule at the
        updates applied: overflow-skipped steps do not count)."""
        if self.offload_enabled:
            return [self._host_lr()]
        return [self.optimizer.lr_at(self._opt_state.count)]

    def loss_scale(self) -> float:
        """The fp16 loss scale of the next step (1.0 without fp16)."""
        if not self.fp16_enabled:
            return 1.0
        return float(self._scaler.cur_scale)

    @property
    def skipped_steps(self) -> int:
        """Overflow-skipped steps so far: the scaler's count, read from the
        last step's metrics when someone asks (``engine.py:1529``)."""
        m = self._cached_metrics
        if "skipped" in m:
            return int(m["skipped"])
        return self._skipped_steps_base

    @skipped_steps.setter
    def skipped_steps(self, v: int) -> None:
        self._skipped_steps_base = int(v)
        # a checkpoint's value takes effect over the last step's metrics
        self._cached_metrics = {}

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
            if not isinstance(self.client_optimizer, Optimizer):
                raise NotImplementedError(
                    f"client optimizer {type(self.client_optimizer).__name__}"
                    ": the PyTorch port takes an ops.optimizers.Optimizer "
                    "(FusedAdam, FusedLamb, SGD, Adagrad, Lion)")
            self.optimizer = self.client_optimizer
        else:
            self.optimizer = get_optimizer(
                self._config.optimizer_name or "adam",
                self._config.optimizer_params or {},
                lr_schedule=self.lr_schedule)

    # -------------------------------------------------------------- fp16
    def _scaler_init(self) -> LossScaleState:
        """The scaler (``engine.py:497``): a static ``loss_scale``, or the
        dynamic one from ``2 ** initial_scale_power``; a full-precision run
        keeps one too, unused, as JAX's state does."""
        args = self._config.dynamic_loss_scale_args
        if self.fp16_enabled and not self.dynamic_loss_scale:
            return LossScaleState.create(self._config.loss_scale,
                                         device=self.device)
        return LossScaleState.create(args["init_scale"],
                                     args["delayed_shift"],
                                     device=self.device)

    def _next_scaler(self, scaler: LossScaleState,
                     overflow) -> LossScaleState:
        args = self._config.dynamic_loss_scale_args
        return update_scale(scaler, overflow,
                            scale_window=args["scale_window"],
                            min_scale=args["min_scale"],
                            delayed_shift=args["delayed_shift"],
                            dynamic=self.dynamic_loss_scale)

    def _grad_scale(self, gas: int):
        """What the summed gradients are multiplied by: ``1 / gas`` (None
        at gas 1), under fp16 the device scalar ``1 / (gas x scale)``."""
        if self.fp16_enabled:
            return 1.0 / (gas * self._scaler.cur_scale)
        return 1.0 / gas if gas > 1 else None

    def _advance_scaler(self, metrics, overflow,
                        scaler) -> Dict[str, Any]:
        """Take the step's scaler and add fp16's three metrics
        (``make_metrics``)."""
        self._scaler = scaler
        if self.fp16_enabled:
            metrics.update(overflow=overflow, loss_scale=scaler.cur_scale,
                           skipped=scaler.skipped)
        return metrics

    # ------------------------------------------------------- ZeRO-Offload
    def _init_offload(self, flat: List[Tuple[tuple, Any]]) -> None:
        """The offloaded state (``_init_offload_optimizer``, ``engine.py:745``,
        and ``_build_state_streamed``, ``:605``) from the ``(path, leaf)``
        list of the weights: the float32 weights, drawn on the device or
        given, become the host masters leaf by leaf (the
        streamed blocks the block optimizer's, the rest the resident
        optimizer's); the device keeps a compute-dtype copy of the resident
        leaves in one flat buffer, their views the leaves autograd sees, and
        one flat float32 gradient accumulator.  The device's float32 copies
        are dropped before the first step."""
        from .zero.offload import DeviceRing, HostOffloadOptimizer, HostRing

        zc = self._config.zero_config
        off = zc.offload_optimizer
        opt_args = dict(optimizer_name=self._config.optimizer_name or "adam",
                        optimizer_params=self._config.optimizer_params or {},
                        device=off.device.value, nvme_path=off.nvme_path,
                        sub_group_size=zc.sub_group_size)
        # ``flat`` is the caller's (path, leaf) list: emptied here, so that
        # weights the engine drew are freed as soon as the host has them
        leaves = [(path, (leaf if isinstance(leaf, torch.Tensor) else
                          torch.as_tensor(np.asarray(leaf))).detach())
                  for path, leaf in flat]
        flat.clear()
        flat = leaves
        del leaves
        if self.param_stream_enabled:
            from .zero.param_stream import StreamedParamStore

            key = self.module.pipeline_hooks["blocks_key"]
            bpath = (key,) if isinstance(key, str) else tuple(key)
            blocks = [(p, t) for p, t in flat if p[:len(bpath)] == bpath]
            flat = [(p, t) for p, t in flat if p[:len(bpath)] != bpath]
            self._block_opt = HostOffloadOptimizer(
                [t for _, t in blocks], **opt_args)
            self._param_store = StreamedParamStore(
                {p[-1]: m for (p, _), m in
                 zip(blocks, self._block_opt.param_leaves())},
                self.compute_dtype, self.device)
            self._block_paths = [p for p, _ in blocks]
            del blocks
        self._paths = [p for p, _ in flat]
        shapes = [tuple(t.shape) for _, t in flat]
        sizes = [t.numel() for _, t in flat]
        total = sum(sizes)
        # the compute copy first, from the float32 leaves where they are
        self._dev_flat = torch.empty(total, dtype=self.compute_dtype,
                                     device=self.device)
        with torch.no_grad():
            start = 0
            for (_, t), n in zip(flat, sizes):
                self._dev_flat[start:start + n].copy_(
                    t.reshape(-1).to(torch.float32))
                start += n
        self._offload_opt = HostOffloadOptimizer([t for _, t in flat],
                                                 **opt_args)
        self.optimizer = self._offload_opt.opt
        del flat
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._dev_grad = torch.zeros(total, dtype=torch.float32,
                                     device=self.device)
        self._leaves = []
        start = 0
        for shape, n in zip(shapes, sizes):
            leaf = self._dev_flat[start:start + n].view(shape)
            leaf.requires_grad_()
            leaf.register_post_accumulate_grad_hook(self._fold_hook(
                self._dev_grad[start:start + n].view(shape)))
            self._leaves.append(leaf)
            start += n
        self._params = _unflatten(self._paths, self._leaves)
        self._ring = (DeviceRing(self._dev_grad, self._dev_flat)
                      if self.device.type == "cuda"
                      else HostRing(self._dev_grad, self._dev_flat))
        self._opt_state = ()
        self.offload_timings: Dict[str, float] = {}
        n_blk = self._block_opt.total if self._block_opt else 0
        log_dist(f"optimizer offload -> {off.device.value}: {total / 1e6:.2f}M "
                 f"resident and {n_blk / 1e6:.2f}M streamed parameters, "
                 f"host optimizer {type(self.optimizer).__name__}", ranks=[0])

    @staticmethod
    def _fold_hook(grad: torch.Tensor):
        """Fold a leaf's gradient into its float32 accumulator view as soon
        as autograd has it, and free it."""
        def fold(leaf):
            grad.add_(leaf.grad)
            leaf.grad = None
        return fold

    def _host_lr(self) -> float:
        """LR for the host optimizer at its *applied* steps
        (``engine.py:1447``)."""
        if self.lr_schedule is not None:
            return float(self.lr_schedule(self._offload_opt.applied_steps))
        return float((self._config.optimizer_params or {}).get("lr", 1e-3))

    def _streamed_loss(self, micro):
        """The loss over streamed blocks (``engine.py:677``): embeddings
        and head from the resident leaves, each block through the store
        (no dropout: refused under ``offload_param``, as in JAX)."""
        hooks = self.module.pipeline_hooks
        batch = self._to_device(micro)
        if isinstance(batch, (tuple, list)):
            inputs, targets = batch
        elif isinstance(batch, dict) and batch.get("labels") is not None:
            inputs, targets = batch["input_ids"], batch["labels"]
        else:
            ids = batch["input_ids"] if isinstance(batch, dict) else batch
            inputs, targets = ids[:, :-1], ids[:, 1:]
        block_fn = hooks["block_fn"]
        apply = self._param_store.streamed_block(
            lambda layer, x: block_fn(layer, x, None))
        x = hooks["embed_fn"](self._params, inputs)
        for i in range(self._param_store.num_layers):
            x = apply(i, x)
        return hooks["head_loss_fn"](self._params, x, targets)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _offload_update(self, mean_loss, grad_scale, t_start: float):
        """The offload step after the micro-steps (``offload_finish``
        ``engine.py:973`` and ``_host_apply`` ``:1455``): scale the
        accumulated gradients by ``grad_scale`` (:meth:`_grad_scale`), take
        the global norm and clip on the device, then under fp16 the
        overflow check (after the clip, as JAX's offload path orders it:
        a non-finite norm makes the clipped gradients NaN) and the scaler;
        step the host masters and send the updated weights back unless the
        step overflowed.  Under ``offload_param`` the streamed blocks'
        gradients are checked on the host too, and an overflow there redoes
        the scaler's step as an overflow (``engine.py:1468-1489``)."""
        grads = self._dev_grad
        if grad_scale is not None:
            grads.mul_(grad_scale)
        norm = torch.linalg.vector_norm(grads)
        clip = self._config.gradient_clipping
        lr = self._host_lr()
        store = self._param_store
        if store is not None:
            # the host clip covers the resident and streamed gradients
            # together (engine.py:1480-1506)
            store.join()
            if grad_scale is not None:
                cpu_adam.scale_(store.grad_flat, float(grad_scale))
            grad_norm = float(np.sqrt(float(norm) ** 2 +
                                      store.sq_grad_norm()))
        else:
            if clip:
                grads.mul_(torch.clamp(clip / (norm + 1e-6), max=1.0))
            grad_norm = norm
        scaler, overflow = self._scaler, False
        if self.fp16_enabled:
            flag = torch.logical_not(torch.isfinite(grads).all())
            scaler = self._next_scaler(self._scaler, flag)
            overflow = bool(flag)
            if store is not None and not overflow and \
                    not np.isfinite(store.grad_flat).all():
                overflow, flag = True, torch.ones_like(flag)
                scaler = self._next_scaler(self._scaler, flag)
        if store is not None and clip and not overflow:
            c = min(1.0, clip / (grad_norm + 1e-6))
            grads.mul_(c)
            cpu_adam.scale_(store.grad_flat, c)
        self._sync()
        t_dev = time.perf_counter()
        if store is not None:
            from .zero.offload import HostRing

            if not overflow:
                self._block_opt.step_stream(
                    HostRing(store.grad_flat, store.compute_flat), lr)
            store.grad_flat.zero_()
        t_blk = time.perf_counter()
        if not overflow:
            self._offload_opt.step_stream(self._ring, lr)
            if self.device.type == "cuda":
                self._ring.finish()
        grads.zero_()
        self._sync()
        t_end = time.perf_counter()
        # the split of the step: the device's micro-steps, norm and clip;
        # the streamed blocks' host step; the resident host step with its
        # transfers (the ring's stats split that one)
        self.offload_timings = {"device_s": t_dev - t_start,
                                "block_step_s": t_blk - t_dev,
                                "offload_step_s": t_end - t_blk,
                                **getattr(self._ring, "stats", {})}
        if store is not None:
            self.offload_timings.update(stream_bytes_in=store.bytes_in,
                                        stream_bytes_out=store.bytes_out)
            store.bytes_in = store.bytes_out = 0
        return self._advance_scaler(
            {"loss": mean_loss, "grad_norm": grad_norm, "lr": lr},
            overflow, scaler)

    # ------------------------------------------------------------------- state
    @property
    def params(self) -> Dict[str, Any]:
        """The float32 master parameters, a nested dict of tensors (under
        offload: host tensors viewing the host masters, the streamed blocks
        included)."""
        if not self.offload_enabled:
            return self._params
        paths = list(self._paths)
        leaves = [torch.from_numpy(m)
                  for m in self._offload_opt.param_leaves()]
        if self._block_opt is not None:
            paths += self._block_paths
            leaves += [torch.from_numpy(m)
                       for m in self._block_opt.param_leaves()]
        return _unflatten(paths, leaves)

    @property
    def state(self) -> Dict[str, Any]:
        params = self.params
        if self._param_store is not None:
            # the streamed blocks live in the host store, as in the JAX
            # engine's device state
            key = self.module.pipeline_hooks["blocks_key"]
            node = params
            for k in ((key,) if isinstance(key, str) else key)[:-1]:
                node = node[k]
            node[((key,) if isinstance(key, str) else key)[-1]] = {}
        return {"step": self.global_steps, "params": params,
                "opt_state": self._opt_state, "scaler": self._scaler}

    # ---------------------------------------------------------------- batching
    def _to_device(self, batch):
        return batch_to_device(batch, self.device)

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
    def _micro_rng(self, index: int, step: Optional[int] = None):
        """The dropout key of micro-step ``index``: ``fold_in(fold_in(
        PRNGKey(seed + 1), step), index)`` (``engine.py:927-948``); the
        micro-step shims fold in the micro-step count alone, as JAX's
        ``micro_grads`` does (``step=None``).  An int64 ``[2]`` CPU tensor,
        derived on the host in Python ints."""
        key = self._dropout_rng
        if step is not None:
            key = fold_in_words(key, step)
        return torch.tensor(fold_in_words(key, index), dtype=torch.int64)

    def _micro_loss(self, micro, rng=None):
        """Loss of one micro-batch with the masters cast to the compute
        dtype inside the autograd graph (under offload: the compute copy,
        or the streamed blocks)."""
        if self._param_store is not None:
            return self._streamed_loss(micro)
        if self.offload_enabled:
            return self.module.loss_fn(self._params, self._to_device(micro),
                                       rng, True)
        params = self._params
        if self.compute_dtype != torch.float32:
            params = _unflatten(self._paths, [
                p.to(self.compute_dtype) if p.is_floating_point() else p
                for p in self._leaves])
        return self.module.loss_fn(params, self._to_device(micro), rng, True)

    def _scaled_backward(self, loss) -> None:
        """``loss.backward()``, under fp16 of ``loss x scale`` in float32
        (``micro_loss``: ``loss.astype(f32) * scale``)."""
        if self.fp16_enabled:
            loss = loss.float() * self._scaler.cur_scale
        loss.backward()

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self._leaves]

    def _apply_update(self, grads: List[torch.Tensor], mean_loss):
        """grads: float32, averaged over the global batch and unscaled
        (``apply_update``, ``engine.py:866``): the norm, under fp16 the
        overflow flag and the scaler's step, then (unless the step
        overflowed) the clip and the optimizer."""
        grad_norm = global_norm(grads)
        scaler, overflow = self._scaler, False
        if self.fp16_enabled:
            flag = has_overflow(grads)
            scaler = self._next_scaler(self._scaler, flag)
            overflow = bool(flag)
        if overflow:
            lr = self.optimizer.lr_at(self._opt_state.count)
        else:
            if self._config.gradient_clipping:
                clip_by_global_norm(grads, self._config.gradient_clipping,
                                    grad_norm)
            lr = self.optimizer.step(self._leaves, grads, self._opt_state)
        for p in self._leaves:
            p.grad = None
        return self._advance_scaler(
            {"loss": mean_loss, "grad_norm": grad_norm, "lr": lr},
            overflow, scaler)

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
        t_start = time.perf_counter()
        loss_sum = None
        for i, micro in enumerate(micros):
            loss = self._micro_loss(micro,
                                    self._micro_rng(i, self.global_steps))
            self._scaled_backward(loss)
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grad_scale = self._grad_scale(gas)
        if self.offload_enabled:
            metrics = self._offload_update(loss_sum / gas, grad_scale,
                                           t_start)
        else:
            grads = self._grads()
            if grad_scale is not None:
                torch._foreach_mul_(grads, grad_scale)
            metrics = self._apply_update(grads, loss_sum / gas)
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
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
        loss = self._micro_loss(batch, self._micro_rng(self.micro_steps))
        if self.wall_clock_breakdown_enabled:
            self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss, allreduce_gradients: bool = True):
        """Accumulate ``loss / gradient_accumulation_steps``'s gradients
        (under fp16 ``loss x scale``'s, divided by ``gas x scale`` at the
        step)."""
        if self.wall_clock_breakdown_enabled:
            self.timers(BACKWARD_GLOBAL_TIMER).start()
        if self.fp16_enabled:
            self._scaled_backward(loss)
        else:
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
        # the shim's backward divided by gas already, except under fp16
        grad_scale = self._grad_scale(self.gradient_accumulation_steps()) \
            if self.fp16_enabled else None
        if self.offload_enabled:
            metrics = self._offload_update(mean_loss, grad_scale,
                                           time.perf_counter())
        else:
            grads = self._grads()
            if grad_scale is not None:
                torch._foreach_mul_(grads, grad_scale)
            metrics = self._apply_update(grads, mean_loss)
        self._accum_losses = []
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._finalize_metrics(metrics)
        if self.wall_clock_breakdown_enabled:
            self.timers(STEP_GLOBAL_TIMER).stop()

    # -------------------------------------------------------------------- eval
    @torch.no_grad()
    def eval_batch(self, batch, rng=None):
        """The loss of ``batch`` with the current weights (no update)."""
        if self._param_store is not None:
            return self._streamed_loss(batch)
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
    def save_checkpoint(self, save_dir=None, tag=None, client_state=None,
                        save_latest=True):
        """Write ``<save_dir>/<tag>/`` (default tag ``global_step{N}``) and
        ``<save_dir>/latest`` (``engine.py:1689``); returns the tag's
        directory."""
        return self.checkpoint_manager.save(save_dir, tag=tag,
                                            client_state=client_state or {},
                                            save_latest=save_latest)

    def load_checkpoint(self, load_dir=None, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a checkpoint (``engine.py:1695``): ``(directory,
        client_state)``, or ``(None, {})`` when there is no ``latest``."""
        return self.checkpoint_manager.load(
            load_dir, tag=tag, load_optimizer_states=load_optimizer_states,
            load_module_only=load_module_only)

    def close(self) -> None:
        """Release the host tiers (the NVMe swap files, the streaming
        worker)."""
        for opt in (self._offload_opt, self._block_opt):
            if opt is not None:
                opt.close()
        if self._param_store is not None:
            self._param_store.close()
