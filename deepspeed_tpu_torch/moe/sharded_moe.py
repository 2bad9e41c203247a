"""Top-k gating and capacity-bucket dispatch / combine — the PyTorch port of
``deepspeed_tpu/moe/sharded_moe.py``.

The same math as the JAX functions: tokens ``[G, S, D]`` in groups (a group
is one row of the call: a prefill window, a decode slot's token, a verify
window), gates ``[G, S, E]``, dispatch and combine tensors ``[G, S, E, C]``
with ``C`` the per-group capacity of each expert (:func:`_capacity`).  A
token past its expert's capacity is dropped from that expert; top-2 gating
renormalises the two gate values after the capacity masks, so a token whose
second choice dropped keeps weight 1 on its first.

Every shape here follows from the input's shape alone and nothing reads a
value back to the host (one-hot by comparison with an ``arange``, no
``.item()``), so the functions run inside a captured CUDA graph.  Under
autograd the router's gradient flows as in the JAX functions: through the
softmax gates that ``combine`` carries and through ``l_aux``'s mean gate
``me``; the one-hots, argmaxes, positions and capacity masks carry none.
Expert parallelism (the JAX package's ``ep`` mesh axis, whose sharding
constraints make XLA insert the all-to-alls) comes with the port's
multi-GPU slice; on one device dispatch and combine are the einsums alone.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import sampling


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    """Tokens-per-expert budget of a group (``sharded_moe.py:23``): the
    ceiling of ``num_tokens / num_experts * capacity_factor``, at least
    ``min_capacity``."""
    capacity = math.ceil(num_tokens / num_experts * capacity_factor)
    return max(capacity, min_capacity)


def _one_hot(idx: torch.Tensor, num: int, dtype=torch.float32):
    """``jax.nn.one_hot``: ``[..., num]`` with 1 at ``idx``; an index
    outside ``[0, num)`` gives a row of zeros.  A comparison with an
    ``arange``, so no bounds check reads the indices back to the host."""
    return (idx[..., None] == torch.arange(num, device=idx.device)).to(dtype)


def _cumsum_exclusive(x: torch.Tensor, axis: int):
    return torch.cumsum(x, dim=axis) - x


def _aux_loss(gates, mask1, e: int):
    """Load-balancing loss ``E * mean_g(sum_e(me * ce))``."""
    me = gates.mean(dim=1)                                      # [G, E]
    ce = mask1.mean(dim=1)                                      # [G, E]
    return (me * ce).sum(dim=-1).mean() * e


def _gumbel_noise(rng, logits):
    """``jax.random.gumbel(rng, logits.shape)`` on logits' device: ``rng``
    a JAX-layout key (a uint32 pair, as a JAX array, numpy array or
    tensor), the draw the port's threefry (``ops/sampling.py``), whose bits
    are JAX's for the same key."""
    key = rng if isinstance(rng, torch.Tensor) else \
        torch.from_numpy(np.asarray(rng).astype(np.int64))
    key = key.to(device=logits.device, dtype=torch.int64)
    return sampling.gumbel(key, tuple(logits.shape)).to(logits.dtype)


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noisy_gate_policy: Optional[str] = None, rng=None,
               drop_tokens: bool = True, used_token_mask=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Top-1 (Switch) gating (``sharded_moe.py:44``).  ``logits``:
    ``[G, S, E]`` float.  Returns ``(l_aux, combine [G, S, E, C],
    dispatch [G, S, E, C] bool, exp_counts [E])``.  ``used_token_mask``
    ``[G, S]`` keeps padding tokens from routing.
    ``noisy_gate_policy="RSample"`` with a key ``rng`` selects each
    token's expert by the argmax of ``logits`` plus Gumbel noise drawn
    from ``rng`` (the gates stay the softmax of the clean logits);
    without a key, or under another policy, the selection is the clean
    argmax, as in the JAX function.  ``drop_tokens=False`` raises, as JAX
    does: its capacity would be the largest expert count, a shape that
    depends on the data."""
    if not drop_tokens:
        raise NotImplementedError(
            "drop_tokens=False needs dynamic capacity, which cannot compile "
            "under jit; raise capacity_factor instead")
    g, s, e = logits.shape
    capacity = _capacity(s, e, capacity_factor, min_capacity)
    if noisy_gate_policy == "RSample" and rng is not None:
        logits_for_sel = logits + _gumbel_noise(rng, logits)
    else:
        logits_for_sel = logits
    gates = torch.softmax(logits, dim=-1)                       # [G, S, E]
    index1 = torch.argmax(logits_for_sel, dim=-1)               # [G, S]
    mask1 = _one_hot(index1, e, gates.dtype)
    if used_token_mask is not None:
        mask1 = mask1 * used_token_mask[..., None].to(mask1.dtype)
    l_aux = _aux_loss(gates, mask1, e)
    locations1 = _cumsum_exclusive(mask1, axis=1)               # [G, S, E]
    pos1 = (locations1 * mask1).sum(dim=-1)                     # [G, S]
    mask1 = mask1 * (locations1 < capacity).to(mask1.dtype)
    gates1 = (gates * mask1).sum(dim=-1)                        # [G, S]
    dispatch = mask1[..., None] * _one_hot(pos1.to(torch.int64), capacity,
                                           mask1.dtype)[:, :, None, :]
    combine = gates1[..., None, None] * dispatch                # [G,S,E,C]
    exp_counts = mask1.sum(dim=(0, 1))
    return l_aux, combine, dispatch.to(torch.bool), exp_counts


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Top-2 (GShard) gating (``sharded_moe.py:90``): the first expert by
    argmax of the gates, the second by argmax of the logits with the first
    masked (ties take the first index, as ``jnp.argmax`` and
    ``torch.argmax`` both do).  Second-choice slots start after every
    first-choice claim of their expert in the group; the two gate values
    renormalise after the capacity masks.  Returns ``(l_aux, combine,
    dispatch, exp_counts)`` as :func:`top1gating`."""
    g, s, e = logits.shape
    capacity = _capacity(s, e, 2 * capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=-1)
    index1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(index1, e, gates.dtype)
    logits_wo1 = torch.where(mask1.to(torch.bool), -math.inf, logits)
    index2 = torch.argmax(logits_wo1, dim=-1)
    mask2 = _one_hot(index2, e, gates.dtype)

    locations1 = _cumsum_exclusive(mask1, axis=1)
    # expert-2 slots start after all of the group's expert-1 claims
    locations2 = _cumsum_exclusive(mask2, axis=1) + \
        mask1.sum(dim=1, keepdim=True)
    l_aux = _aux_loss(gates, mask1, e)

    mask1 = mask1 * (locations1 < capacity).to(mask1.dtype)
    mask2 = mask2 * (locations2 < capacity).to(mask2.dtype)
    pos1 = (locations1 * mask1).sum(dim=-1)
    pos2 = (locations2 * mask2).sum(dim=-1)

    gates1 = (gates * mask1).sum(dim=-1)
    gates2 = (gates * mask2).sum(dim=-1)
    denom = (gates1 + gates2).clamp(min=torch.finfo(gates.dtype).eps)
    gates1, gates2 = gates1 / denom, gates2 / denom

    disp1 = mask1[..., None] * _one_hot(pos1.to(torch.int64), capacity,
                                        mask1.dtype)[:, :, None, :]
    disp2 = mask2[..., None] * _one_hot(pos2.to(torch.int64), capacity,
                                        mask2.dtype)[:, :, None, :]
    combine = gates1[..., None, None] * disp1 + gates2[..., None, None] * disp2
    dispatch = (disp1 + disp2).to(torch.bool)
    exp_counts = (mask1 + mask2).sum(dim=(0, 1))
    return l_aux, combine, dispatch, exp_counts


def dispatch_tokens(x, dispatch_mask):
    """``[G, S, D]``, ``[G, S, E, C]`` -> expert inputs ``[E, G, C, D]``
    (``sharded_moe.py:132``).  Each ``(e, g, c)`` slot sums at most one
    token times 1, so the result is exact in any precision."""
    return torch.einsum("gsec,gsd->egcd", dispatch_mask.to(x.dtype), x)


def combine_tokens(expert_out, combine_weights):
    """``[E, G, C, D]``, ``[G, S, E, C]`` -> ``[G, S, D]``
    (``sharded_moe.py:138``): the combine weights rounded to the experts'
    dtype, as the JAX einsum takes them, and the products summed in
    float32 (a TPU einsum's accumulator) before one cast back.  A token
    has at most k nonzero terms, so the f32 sum is the same whatever order
    a GEMM library adds its zeros in: a row's bits do not depend on the
    call's other rows."""
    w = combine_weights.to(expert_out.dtype).float()
    out = torch.einsum("gsec,egcd->gsd", w, expert_out.float())
    return out.to(expert_out.dtype)
