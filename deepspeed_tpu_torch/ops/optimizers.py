"""Optimizers — the port of ``deepspeed_tpu/ops/optimizers.py``: Adam /
AdamW (``FusedAdam``), LAMB (``FusedLamb``), SGD with momentum and
Nesterov (``SGD``), Adagrad and Lion.

The JAX package builds each as an optax chain and chains
``clip_by_global_norm`` before it.  This module follows optax's arithmetic
exactly, which is not ``torch.optim``'s.  Adam:

 - the update is ``mu_hat / (sqrt(nu_hat) + eps)``;
 - AdamW mode adds ``weight_decay * p`` to that update before the ``-lr``
   scale; plain Adam mode adds it to the gradient before the moments;
 - ``bias_correction=False`` multiplies the update back by
   ``(1 - b1^t) / sqrt(1 - b2^t)``;
 - a schedule is read at the number of updates already applied (0 first);
 - clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
   with no epsilon.

LAMB (``fused_lamb``): Adam's update, plus ``weight_decay * p``, scaled
per leaf by the trust ratio ``||p|| / ||u||`` clamped to ``[min_coeff,
max_coeff]`` (1 where either norm is 0: ``scale_by_clamped_trust_ratio``),
then ``-lr``.  SGD (``optax.sgd`` after ``add_decayed_weights``): the
trace ``g + momentum * trace``, and with Nesterov ``g + momentum *
trace``.  Adagrad (``optax.adagrad`` after ``add_decayed_weights``): the
sum of squares starts at 0.1 and the update is ``g / sqrt(sum + eps)``.
Lion (``optax.lion``): ``sign((1 - b1) g + b1 m)`` plus ``weight_decay *
p``, and ``m`` moves to ``(1 - b2) g + b2 m``.

Each update runs in place over the engine's list of float32 master tensors
with ``torch._foreach_*`` ops (the XLA-fused update of the JAX package; no
hand-written kernel there either), :data:`STEP_CHUNK` elements at a time:
its float32 temporaries then stay at 1 GiB each rather than copies of the
model (Mixtral-8x7B's 3.2 B parameters at 2 layers would need 25 GB
more).  The arithmetic is elementwise, so the chunks give the bits of one
whole pass; LAMB's per-leaf norms keep each leaf in one piece.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]

#: elements of one pass of :meth:`FusedAdam.step`; a contiguous tensor
#: larger than this is stepped as views of at most this many elements
STEP_CHUNK = 1 << 28


def _chunks(lists: Sequence[Sequence[torch.Tensor]], budget: int,
            split: bool = True):
    """Parallel lists of same-shaped tensors (params, grads, moments) as
    groups of parallel lists of views, each group at most ``budget``
    elements (a tensor that is not contiguous in every list stays whole,
    and so does every tensor without ``split``)."""
    group: List[List[torch.Tensor]] = [[] for _ in lists]
    size = 0
    for ts in zip(*lists):
        n = ts[0].numel()
        if split and n > budget and all(t.is_contiguous() for t in ts):
            flat = [t.view(-1) for t in ts]
            pieces = [tuple(f[i:i + budget] for f in flat)
                      for i in range(0, n, budget)]
        else:
            pieces = [ts]
        for piece in pieces:
            m = piece[0].numel()
            if size and size + m > budget:
                yield group
                group, size = [[] for _ in lists], 0
            for out, t in zip(group, piece):
                out.append(t)
            size += m
    if size or group[0]:
        yield group


def _bias_correction(beta: float, count: int) -> float:
    """``1 - beta**count`` in float32, as optax computes it: in float64,
    ``1 - 0.999`` differs from float32's by 1.2e-5 relative, which the
    update would carry."""
    one = np.float32(1.0)
    return float(one - np.float32(beta) ** np.float32(count))


@dataclasses.dataclass
class AdamState:
    """Moments and update count (optax ``ScaleByAdamState``; LAMB's)."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass
class TraceState:
    """SGD's update count and momentum trace (optax ``TraceState``; no
    buffer without momentum)."""
    count: int
    trace: List[torch.Tensor]


@dataclasses.dataclass
class RssState:
    """Adagrad's update count and sum of squares (``ScaleByRssState``)."""
    count: int
    sum_of_squares: List[torch.Tensor]


@dataclasses.dataclass
class LionState:
    """Lion's update count and moment (``ScaleByLionState``)."""
    count: int
    mu: List[torch.Tensor]


def state_buffers(state) -> List[str]:
    """The names of an optimizer state's per-parameter buffer lists (a
    checkpoint stores each under its name, beside ``count``)."""
    return [f.name for f in dataclasses.fields(state) if f.name != "count"]


class Optimizer:
    """An optax-equivalent update over a list of float32 tensors: ``init``
    makes the state, ``step`` applies one update in place, in chunks of at
    most :data:`STEP_CHUNK` elements, reading the schedule at the number
    of updates already applied.  Subclasses name their state class and
    buffers (``BUFFERS``: (name, initial value)) and define ``_update``
    over one chunk's parallel lists."""

    STATE: type = AdamState
    BUFFERS: Tuple[Tuple[str, float], ...] = ()
    #: leaves may be cut into views (False: the update reads a whole leaf)
    SPLIT = True

    lr: ScalarOrSchedule

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after ``count`` applied ones."""
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: Sequence[torch.Tensor]):
        return self.STATE(count=0, **{
            name: [torch.full_like(p, value) for p in params]
            for name, value in self.BUFFERS})

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state) -> float:
        """Apply one update to ``params`` in place and advance ``state``;
        returns the lr used.  Weight decay that optax adds to the gradient
        is added to ``grads`` in place."""
        lr = self.lr_at(state.count)
        state.count += 1
        bufs = [getattr(state, name) for name, _ in self.BUFFERS]
        for group in _chunks((params, grads, *bufs), STEP_CHUNK, self.SPLIT):
            self._update(*group, count=state.count, lr=lr)
        return lr

    def _update(self, params, grads, *bufs, count: int, lr: float) -> None:
        raise NotImplementedError


class FusedAdam(Optimizer):
    """Adam/AdamW (reference FusedAdam names: betas, eps, weight_decay,
    bias_correction, adam_w_mode) over a list of float32 tensors."""

    STATE = AdamState
    BUFFERS = (("mu", 0.0), ("nu", 0.0))

    def __init__(self, lr: ScalarOrSchedule = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 adam_w_mode: bool = True, amsgrad: bool = False):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad "
                             "(matches reference)")
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adam_w_mode = adam_w_mode

    def _update(self, params, grads, mu, nu, *, count: int,
                lr: float) -> None:
        """One pass of the update over parallel lists of tensors."""
        wd = self.weight_decay
        if wd and not self.adam_w_mode:
            torch._foreach_add_(grads, params, alpha=wd)
        update = _adam_direction(grads, mu, nu, self.b1, self.b2, self.eps,
                                 count)
        if not self.bias_correction:
            c1 = _bias_correction(self.b1, count)
            c2 = _bias_correction(self.b2, count)
            torch._foreach_mul_(
                update, float(np.float32(c1) / np.sqrt(np.float32(c2))))
        if wd and self.adam_w_mode:
            torch._foreach_add_(update, params, alpha=wd)
        torch._foreach_add_(params, update, alpha=-lr)


def _adam_direction(grads, mu, nu, b1: float, b2: float, eps: float,
                    count: int) -> List[torch.Tensor]:
    """optax ``scale_by_adam``: the moments updated in place and the
    direction ``(mu / c1) / (sqrt(nu / c2) + eps)`` as new tensors."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(nu, _bias_correction(b2, count))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(mu, _bias_correction(b1, count))
    torch._foreach_div_(update, denom)
    return update


class FusedLamb(Optimizer):
    """LAMB (``fused_lamb``: ``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_clamped_trust_ratio``, the lr), reference FusedLamb names.
    The trust ratio is per leaf, so leaves are never cut into chunks."""

    STATE = AdamState
    BUFFERS = (("mu", 0.0), ("nu", 0.0))
    SPLIT = False

    def __init__(self, lr: ScalarOrSchedule = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, min_coeff: float = 0.01,
                 max_coeff: float = 0.3):
        if not 0.0 < min_coeff <= max_coeff:
            raise ValueError(f"need 0 < min_coeff <= max_coeff, got "
                             f"[{min_coeff}, {max_coeff}]")
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.min_coeff, self.max_coeff = min_coeff, max_coeff

    def _update(self, params, grads, mu, nu, *, count: int,
                lr: float) -> None:
        update = _adam_direction(grads, mu, nu, self.b1, self.b2, self.eps,
                                 count)
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        p_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(update))
        ratio = torch.clamp(p_norm / torch.where(u_norm == 0, 1.0, u_norm),
                            self.min_coeff, self.max_coeff)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, ratio)
        for u, r in zip(update, ratio):
            u.mul_(r)
        torch._foreach_add_(params, update, alpha=-lr)


class SGD(Optimizer):
    """SGD (``optax.sgd`` after ``add_decayed_weights``): momentum 0 keeps
    no trace; ``nesterov`` steps by ``g + momentum * trace``."""

    STATE = TraceState

    def __init__(self, lr: ScalarOrSchedule = 1e-3, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.BUFFERS = (("trace", 0.0),) if momentum else ()

    def init(self, params):
        return TraceState(count=0, trace=[torch.zeros_like(p) for p in params]
                          if self.momentum else [])

    def _update(self, params, grads, *trace, count: int, lr: float) -> None:
        if self.weight_decay:
            torch._foreach_add_(grads, params, alpha=self.weight_decay)
        update = grads
        if trace:
            (trace,) = trace
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            update = trace
            if self.nesterov:
                update = torch._foreach_mul(trace, self.momentum)
                torch._foreach_add_(update, grads)
        torch._foreach_add_(params, update, alpha=-lr)


class Adagrad(Optimizer):
    """Adagrad (``optax.adagrad`` after ``add_decayed_weights``): the sum
    of squares starts at 0.1 (optax's ``initial_accumulator_value``), so
    it is positive and ``rsqrt(sum + eps)`` needs no zero guard."""

    STATE = RssState
    BUFFERS = (("sum_of_squares", 0.1),)

    def __init__(self, lr: ScalarOrSchedule = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay

    def _update(self, params, grads, sos, *, count: int, lr: float) -> None:
        if self.weight_decay:
            torch._foreach_add_(grads, params, alpha=self.weight_decay)
        torch._foreach_addcmul_(sos, grads, grads)
        update = torch._foreach_add(sos, self.eps)
        torch._foreach_rsqrt_(update)
        torch._foreach_mul_(update, grads)
        torch._foreach_add_(params, update, alpha=-lr)


class Lion(Optimizer):
    """Lion (``optax.lion``): ``sign((1 - b1) g + b1 m)`` plus
    ``weight_decay * p``, then ``m = (1 - b2) g + b2 m``."""

    STATE = LionState
    BUFFERS = (("mu", 0.0),)

    def __init__(self, lr: ScalarOrSchedule = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        self.lr = lr
        self.b1, self.b2 = betas
        self.weight_decay = weight_decay

    def _update(self, params, grads, mu, *, count: int, lr: float) -> None:
        update = torch._foreach_mul(grads, 1.0 - self.b1)
        torch._foreach_add_(update, torch._foreach_mul(mu, self.b1))
        torch._foreach_sign_(update)
        torch._foreach_mul_(mu, self.b2)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b2))
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)


@torch.no_grad()
def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax
    ``global_norm``), a 0-d float32 tensor."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


@torch.no_grad()
def clip_by_global_norm(tensors: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``tensors`` in place by ``max_norm / norm`` when
    ``norm >= max_norm`` (optax ``clip_by_global_norm``: no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns the norm before
    clipping."""
    if norm is None:
        norm = global_norm(tensors)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(tensors, factor)
    return norm


def get_optimizer(name: str, params: dict,
                  lr_schedule: Optional[Callable[[int], float]] = None
                  ) -> Optimizer:
    """Map a reference optimizer name and its params to an optimizer
    (``optimizers.py:148``).  "adam" is AdamW unless ``adam_w_mode`` is
    false; "adamw" always is."""
    name = name.lower()
    params = dict(params)
    params.pop("torch_adam", None)
    params.pop("fused", None)
    lr = lr_schedule if lr_schedule is not None else params.pop("lr", 1e-3)
    if lr_schedule is not None:
        params.pop("lr", None)
    if name in ("adam", "adamw", "fusedadam"):
        adam_w_mode = True if name == "adamw" else \
            bool(params.pop("adam_w_mode", True))
        return FusedAdam(lr=lr,
                         betas=tuple(params.pop("betas", (0.9, 0.999))),
                         eps=params.pop("eps", 1e-8),
                         weight_decay=params.pop("weight_decay", 0.0),
                         bias_correction=params.pop("bias_correction", True),
                         adam_w_mode=adam_w_mode)
    if name in ("lamb", "fusedlamb"):
        return FusedLamb(lr=lr, betas=tuple(params.pop("betas", (0.9, 0.999))),
                         eps=params.pop("eps", 1e-8),
                         weight_decay=params.pop("weight_decay", 0.0),
                         min_coeff=params.pop("min_coeff", 0.01),
                         max_coeff=params.pop("max_coeff", 0.3))
    if name == "sgd":
        return SGD(lr=lr, momentum=params.pop("momentum", 0.0),
                   weight_decay=params.pop("weight_decay", 0.0),
                   nesterov=params.pop("nesterov", False))
    if name == "adagrad":
        return Adagrad(lr=lr, eps=params.pop("eps", 1e-10),
                       weight_decay=params.pop("weight_decay", 0.0))
    if name == "lion":
        return Lion(lr=lr, betas=tuple(params.pop("betas", (0.9, 0.99))),
                    weight_decay=params.pop("weight_decay", 0.0))
    raise NotImplementedError(
        f"optimizer {name!r}: the PyTorch port runs adam, adamw, fusedadam, "
        "lamb, sgd, adagrad and lion; the 1-bit optimizers come with the "
        "multi-GPU slice (ROADMAP.md Queue A 8)")
