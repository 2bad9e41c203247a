"""Loss scaling for fp16 training — the port's copy of
``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (reference
``deepspeed/runtime/fp16/loss_scaler.py``: ``LossScaler`` :54,
``DynamicLossScaler`` :77).

The state is four 0-d tensors on the engine's device, updated by tensor
operations only, so the scaler reads nothing back to the host (the
engine reads the overflow flag once a step, to skip the optimizer):

    state  = {cur_scale f32, cur_hysteresis i32, good_steps i32, skipped i32}
    scaled_loss = loss * cur_scale
    overflow    = any(!isfinite(grads))     (one device-side reduction)
    on overflow: scale /= 2 once the hysteresis is spent; the step is skipped
    else: after scale_window good steps in a row, scale *= 2

The arithmetic is JAX's bit for bit: ``cur_scale / scale_factor`` and
``cur_scale * scale_factor`` in float32, ``max(..., min_scale)`` against the
float32 ``min_scale``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

#: the state's fields in JAX's order (``LossScaleState``), the names a
#: checkpoint stores them under
FIELDS = ("cur_scale", "cur_hysteresis", "good_steps", "skipped")


@dataclasses.dataclass
class LossScaleState:
    """All-tensor state (JAX's ``LossScaleState``); whether scaling is
    dynamic is a property of the step (``update_scale(dynamic=...)``)."""
    cur_scale: torch.Tensor        # f32 scalar
    cur_hysteresis: torch.Tensor   # i32 scalar
    good_steps: torch.Tensor       # i32 scalar
    skipped: torch.Tensor          # i32 scalar, total skipped steps

    @staticmethod
    def create(init_scale: float = 2.0**16, delayed_shift: int = 2,
               device=None) -> "LossScaleState":
        return LossScaleState(
            cur_scale=torch.tensor(init_scale, dtype=torch.float32,
                                   device=device),
            cur_hysteresis=torch.tensor(delayed_shift, dtype=torch.int32,
                                        device=device),
            good_steps=torch.tensor(0, dtype=torch.int32, device=device),
            skipped=torch.tensor(0, dtype=torch.int32, device=device))


def has_overflow(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """True iff any gradient entry is NaN or Inf: a 0-d bool tensor on the
    gradients' device (one ``isfinite().all()`` a leaf; the models keep
    their layers stacked, so a few dozen leaves)."""
    if not grads:
        return torch.tensor(False)
    finite = torch.stack([torch.isfinite(g).all() for g in grads])
    return torch.logical_not(finite.all())


@torch.no_grad()
def update_scale(state: LossScaleState, overflow: torch.Tensor,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 scale_factor: float = 2.0, delayed_shift: int = 2,
                 consecutive_hysteresis: bool = False,
                 dynamic: bool = True) -> LossScaleState:
    """The post-step scale adjustment (reference
    ``DynamicLossScaler.update_scale``), both branches computed and one
    selected by ``overflow`` (``lax.cond`` in JAX).  ``dynamic=False`` is
    the static ``LossScaler`` (:54): the scale never moves, but skipped
    steps are still counted."""
    ov = overflow.to(torch.bool)
    skipped = state.skipped + ov.to(torch.int32)
    if not dynamic:
        return dataclasses.replace(state, skipped=skipped)
    scale, hyst, good = state.cur_scale, state.cur_hysteresis, \
        state.good_steps
    shift = torch.full_like(hyst, delayed_shift)
    # overflow
    exhausted = hyst <= 1
    lowered = torch.maximum(scale / scale_factor,
                            torch.full_like(scale, min_scale))
    ov_scale = torch.where(exhausted, lowered, scale)
    ov_hyst = torch.where(exhausted, hyst, hyst - 1)
    # good step: hysteresis refills every good step with
    # consecutive_hysteresis, else at scale_window boundaries only
    window_hit = torch.remainder(good + 1, scale_window) == 0
    ok_scale = torch.where(window_hit, scale * scale_factor, scale)
    ok_hyst = shift if consecutive_hysteresis else \
        torch.where(window_hit, shift, hyst)
    return LossScaleState(
        cur_scale=torch.where(ov, ov_scale, ok_scale),
        cur_hysteresis=torch.where(ov, ov_hyst, ok_hyst),
        good_steps=torch.where(ov, torch.zeros_like(good), good + 1),
        skipped=skipped)
