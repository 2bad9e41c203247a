"""Optimizers — the port's copy of the Adam half of
``deepspeed_tpu/ops/optimizers.py``.

The JAX package builds ``fused_adam`` as an optax chain (``scale_by_adam``,
optionally the bias-correction undo, weight decay, then the learning-rate
scale) and chains ``clip_by_global_norm`` before it.  This module follows
that arithmetic exactly, which is not ``torch.optim.AdamW``'s:

 - the update is ``mu_hat / (sqrt(nu_hat) + eps)``;
 - AdamW mode adds ``weight_decay * p`` to that update before the ``-lr``
   scale; plain Adam mode adds it to the gradient before the moments;
 - ``bias_correction=False`` multiplies the update back by
   ``(1 - b1^t) / sqrt(1 - b2^t)``;
 - a schedule is read at the number of updates already applied (0 first);
 - clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
   with no epsilon.

The update runs in place over the engine's list of float32 master tensors
with ``torch._foreach_*`` ops (the XLA-fused update of the JAX package; no
hand-written kernel there either), :data:`STEP_CHUNK` elements at a time:
its two float32 temporaries then stay at 1 GiB each rather than two
copies of the model (Mixtral-8x7B's 3.2 B parameters at 2 layers would
need 25 GB more).  The arithmetic is elementwise, so the chunks give the
bits of one whole pass.  Optimizers other than Adam/AdamW come with a
later slice.
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


def _chunks(lists: Sequence[Sequence[torch.Tensor]], budget: int):
    """Parallel lists of same-shaped tensors (params, grads, moments) as
    groups of parallel lists of views, each group at most ``budget``
    elements (a tensor that is not contiguous in every list stays whole)."""
    group: List[List[torch.Tensor]] = [[] for _ in lists]
    size = 0
    for ts in zip(*lists):
        n = ts[0].numel()
        if n > budget and all(t.is_contiguous() for t in ts):
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
    """Moments and update count (optax ``ScaleByAdamState``)."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class FusedAdam:
    """Adam/AdamW (reference FusedAdam names: betas, eps, weight_decay,
    bias_correction, adam_w_mode) over a list of float32 tensors."""

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

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after ``count`` applied ones."""
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: AdamState) -> float:
        """Apply one update to ``params`` in place and advance ``state``;
        returns the lr used.  Plain-Adam weight decay is added to ``grads``
        in place."""
        lr = self.lr_at(state.count)
        state.count += 1
        for group in _chunks((params, grads, state.mu, state.nu),
                             STEP_CHUNK):
            self._update(*group, state.count, lr)
        return lr

    def _update(self, params, grads, mu, nu, count: int, lr: float) -> None:
        """One pass of the update over parallel lists of tensors."""
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        if wd and not self.adam_w_mode:
            torch._foreach_add_(grads, params, alpha=wd)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        c1 = _bias_correction(b1, count)
        c2 = _bias_correction(b2, count)
        # update = (mu / c1) / (sqrt(nu / c2) + eps)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, c1)
        torch._foreach_div_(update, denom)
        del denom
        if not self.bias_correction:
            torch._foreach_mul_(
                update, float(np.float32(c1) / np.sqrt(np.float32(c2))))
        if wd and self.adam_w_mode:
            torch._foreach_add_(update, params, alpha=wd)
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
                  ) -> FusedAdam:
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
    raise NotImplementedError(
        f"optimizer {name!r}: the PyTorch port runs adam, adamw and fusedadam "
        "so far; the others come with the optimizer slice (ROADMAP.md)")
