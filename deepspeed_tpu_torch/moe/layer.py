"""The MoE layer — the PyTorch port of ``deepspeed_tpu/moe/layer.py``.

Functional, as in the JAX package: a gate ``gate_w [D, E]`` and expert
weights stacked on a leading expert axis (``w1``/``w3 [E, D, F]`` and ``w2
[E, F, D]`` for the SwiGLU experts of Mixtral, ``fc_w``/``fc_b``/
``proj_w``/``proj_b`` for the GELU MLP of the reference ``Experts``).
:func:`moe_apply` gates, dispatches each group's tokens into capacity
buckets ``[E, G, C, D]``, runs every expert's MLP over its buckets as
batched matmuls (``torch.bmm`` over the expert axis: the JAX package leaves
these products to XLA, outside any Pallas kernel) and combines.

Two choices keep a row's bf16 arithmetic the same whatever else shares its
call (the JAX package needs neither on the TPU):

 - the gate logits are summed in float64 and rounded to the activation
   dtype, as the JAX matmul's output is: products of bf16 (or f32) values
   are exact in f64 and their sum over D rounds back to the same value in
   any order, so no GEMM's choice of kernel by row count reaches the
   routing;
 - ``rows`` runs the expert products on the fixed row counts that llama's
   and OPT's matmuls take (``utils/rows.py``): a prefill window's bucket
   rows in 256-row blocks, a decode step's padded to 8 groups' worth and
   never split.

Expert leaves that are int8 records (quantized serving) dequantize here,
one layer's experts at a time, at the point of use (``layer.py:135-143``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import quantization as quant
from ..utils.rows import fixed_rows
from .sharded_moe import combine_tokens, dispatch_tokens, top1gating, \
    top2gating

PyTree = Any


@dataclasses.dataclass
class MoEConfig:
    hidden_size: int
    ffn_hidden_size: int
    num_experts: int = 1
    k: int = 1                      # top-1 or top-2 gating
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    activation: str = "gelu"        # gelu (reference experts) or silu_glu


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    dtype=torch.float32) -> PyTree:
    """Random MoE parameters with the shapes and scales of the JAX
    ``init_moe_params`` (``layer.py:40``: std 0.02, zero biases), drawn
    from ``generator`` on its device; the draws differ from JAX's."""
    d, f, e = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_experts
    dev = generator.device

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02
                ).to(dtype)

    params = {"gate_w": normal((d, e))}
    if cfg.activation == "silu_glu":
        params["experts"] = {"w1": normal((e, d, f)), "w2": normal((e, f, d)),
                             "w3": normal((e, d, f))}
    else:
        params["experts"] = {
            "fc_w": normal((e, d, f)),
            "fc_b": torch.zeros((e, f), dtype=dtype, device=dev),
            "proj_w": normal((e, f, d)),
            "proj_b": torch.zeros((e, d), dtype=dtype, device=dev)}
    return params


def _maybe_constrain(x, spec=None):
    """The JAX package's sharding constraint on the ``ep`` axis: the
    identity on one device (``ep_size > 1`` is refused by the engines)."""
    del spec
    return x


def gate_logits(x, gate_w) -> torch.Tensor:
    """``(x @ gate_w)`` in x's dtype, then float32 (``layer.py:118``), the
    sum taken in float64 (module docstring) so the routing of a token does
    not depend on the rows sharing its call."""
    w = gate_w.to(x.dtype).to(torch.float64)
    return (x.to(torch.float64) @ w).to(x.dtype).to(torch.float32)


def _expert_mlp(cfg: MoEConfig, w: PyTree, x):
    """Every expert's MLP on its rows: ``x [E, R, D]`` -> ``[E, R, D]``
    (``layer.py:96``, vmapped over E there)."""
    if cfg.activation == "silu_glu":
        h = F.silu(torch.bmm(x, w["w1"])) * torch.bmm(x, w["w3"])
        return torch.bmm(h, w["w2"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(torch.bmm(x, w["fc_w"]) + w["fc_b"][:, None],
               approximate="tanh")
    return torch.bmm(h, w["proj_w"]) + w["proj_b"][:, None]


def _dense(leaf, dtype):
    """An expert leaf in ``dtype``: int8 records expanded (K-grouped w8a8
    or weight-only), dense leaves cast."""
    if quant.is_k_quantized(leaf):
        return quant.dequantize_k(leaf, dtype)
    if quant.is_quantized(leaf):
        return quant.dequantize(leaf, dtype)
    return leaf.to(dtype)


def moe_apply(cfg: MoEConfig, params: PyTree, x, rng=None, train: bool = True,
              rows: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN (``layer.py:104``).  ``x``: ``[..., S, D]``, leading
    dims taken as groups (a 2-D input is one group).  Returns ``(y,
    aux_loss)``.  ``train`` picks ``capacity_factor`` (else
    ``eval_capacity_factor``) and, for top-1 gating, the config's noisy
    gate policy with the key ``rng`` (``"RSample"``: Gumbel noise on the
    selection, :func:`top1gating`); evaluation gates on the clean logits.
    Every operation is differentiable as the JAX one is: the gradient
    reaches the router through ``combine`` and the aux loss.  ``rows``
    (port-only, serving): ``"prefill"`` or ``"decode"``, the expert
    products on fixed row counts (module docstring); None = one call, as
    training runs them."""
    orig_shape = x.shape
    d = orig_shape[-1]
    if x.ndim > 3:
        x3 = x.reshape((-1,) + tuple(orig_shape[-2:]))
    elif x.ndim == 2:
        x3 = x[None]
    else:
        x3 = x

    logits = gate_logits(x3, params["gate_w"])
    cap = cfg.capacity_factor if train else cfg.eval_capacity_factor
    if cfg.k == 1:
        l_aux, combine, dispatch, _ = top1gating(
            logits, cap, cfg.min_capacity,
            noisy_gate_policy=cfg.noisy_gate_policy if train else None,
            rng=rng if train else None, drop_tokens=cfg.drop_tokens)
    elif cfg.k == 2:
        l_aux, combine, dispatch, _ = top2gating(logits, cap,
                                                 cfg.min_capacity)
    else:
        raise ValueError(f"k={cfg.k} not supported (reference supports 1 "
                         "or 2)")

    expert_in = _maybe_constrain(dispatch_tokens(x3, dispatch))  # [E,G,C,D]
    e, g, c, _ = expert_in.shape
    w = {k: _dense(v, x3.dtype) for k, v in params["experts"].items()}
    buckets = expert_in.reshape(e, g * c, d)
    if rows is None:
        expert_out = _expert_mlp(cfg, w, buckets)
    else:
        # a decode floor counts groups: each holds c bucket rows
        expert_out = fixed_rows(lambda r: _expert_mlp(cfg, w, r), buckets,
                                rows, unit=c)
    del w
    expert_out = _maybe_constrain(expert_out.reshape(e, g, c, d))
    y = combine_tokens(expert_out, combine).to(x.dtype)
    return y.reshape(orig_shape), l_aux.to(torch.float32)
