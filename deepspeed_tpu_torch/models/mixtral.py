"""Mixtral (sparse-MoE Llama) — the PyTorch port of
``deepspeed_tpu/models/mixtral.py``: generation, paged serving, and
training (the forward and loss with the router's aux loss, through
``initialize`` -> ``train_batch``).

Llama attention blocks (``models/llama.py``) with the FFN replaced by a
top-2-gated MoE (``deepspeed_tpu_torch.moe``): expert weights stacked
``[L, E, ...]`` (``experts_w1``/``experts_w3 [L, E, D, F]``, ``experts_w2
[L, E, F, D]``) beside the router ``gate_w [L, D, E]``.  The cached path is
llama's with the MoE FFN hooked in (``llama.forward_cached(mlp_fn=...)``),
so the attention projections of w8a8 records keep the indexed stacked
kernel, the attention runs the decode kernels, and the int8 KV pool passes
through untouched.  Expert leaves quantize with the blocks (w8a8: K-grouped
records ``[L, E, K, N]``; the router's N = E is no multiple of 128 and
stays dense, as in the JAX package) and dequantize one layer at a time at
the point of use.

Capacity is per group, and a group is one row of a call: a prefill window
of ``prefill_chunk`` tokens (its pads routed too), a decode slot's token,
a speculative verify window (gated as one window even though its attention
projections run one position at a time), ``generate``'s prompt.  The
expert products run on llama's fixed row counts (``utils/rows.py``), so a
row's bf16 result does not depend on how many groups share its call.

``init_params`` draws layer after layer (every leaf of layer 0, then of
layer 1, ...), after the embedding, the final norm and the head, so its
``num_layers`` draws the first layers of the config's model (``o_w``'s
scale follows the config's depth, as in the JAX initializer), and a
``layer_fn`` (the inference engine's quantizer) turns each layer into int8
records as it is drawn, so the 93 GB bf16 Mixtral-8x7B never exists on the
card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from . import gpt2
from . import llama as L
from ..moe.layer import MoEConfig, moe_apply

Params = Dict[str, Any]


@dataclasses.dataclass
class MixtralConfig(L.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    #: eval/inference capacity (``mixtral.py:39``): ``num_experts`` gives
    #: drop-free routing
    eval_capacity_factor: float = 2.0
    router_aux_loss_coef: float = 0.02

    @staticmethod
    def mixtral_8x7b() -> "MixtralConfig":
        return MixtralConfig(vocab_size=32000, num_layers=32, num_heads=32,
                             num_kv_heads=8, hidden_size=4096, ffn_size=14336,
                             rope_theta=1e6, num_experts=8, top_k=2)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "MixtralConfig":
        return MixtralConfig(vocab_size=vocab_size, max_seq_len=128,
                             num_layers=2, num_heads=4, num_kv_heads=2,
                             hidden_size=64, ffn_size=128, rope_theta=10000.0,
                             num_experts=4, top_k=2, remat=False)

    def num_params(self) -> int:
        base = super().num_params()
        d, f = self.hidden_size, self.ffn_size
        per_layer_mlp = 3 * d * f
        return base + self.num_layers * (
            (self.num_experts - 1) * per_layer_mlp + d * self.num_experts)

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(hidden_size=self.hidden_size,
                         ffn_hidden_size=self.ffn_size,
                         num_experts=self.num_experts, k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         eval_capacity_factor=self.eval_capacity_factor,
                         activation="silu_glu")


def _layer_shapes(cfg: MixtralConfig):
    """(name, shape of one layer, std or None for ones), in the JAX
    tree's order (``mixtral.py:72``: llama's blocks without the dense MLP,
    then the router and the experts)."""
    d, f, e = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    std = 0.02
    return (("attn_norm", (d,), None), ("q_w", (d, hq), std),
            ("k_w", (d, hkv), std), ("v_w", (d, hkv), std),
            ("o_w", (hq, d), std / math.sqrt(2 * cfg.num_layers)),
            ("mlp_norm", (d,), None), ("gate_w", (d, e), std),
            ("experts_w1", (e, d, f), std), ("experts_w3", (e, d, f), std),
            ("experts_w2", (e, f, d), std))


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                layer_fn: Optional[Callable] = None,
                num_layers: Optional[int] = None) -> Params:
    """Random Mixtral parameters with the shapes and scales of the JAX
    ``init_params`` (``mixtral.py:72``: llama's, std 0.02 for the router
    and the experts), drawn from ``generator`` on its device in float32
    and stored in ``dtype``: the embedding, final norm and LM head first,
    then layer after layer (module docstring; ``layer_fn`` as in
    ``gpt2.draw_layers``); ``num_layers`` (default the config's) stops
    after that many.  The draws differ from JAX's; to run the same
    weights in both packages use :func:`params_from_jax`."""
    dev = generator.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"init_params draws on the generator's device "
                         f"{dev}, not {device}")

    def normal(shape, s=0.02):
        return (torch.randn(shape, generator=generator, device=dev) * s
                ).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    d, v = cfg.hidden_size, cfg.vocab_size
    params = {"embed": normal((v, d)), "final_norm": ones((d,)),
              "lm_head": normal((d, v))}
    params["blocks"] = gpt2.draw_layers(
        _layer_shapes(cfg), cfg.num_layers if num_layers is None
        else num_layers, normal, ones, layer_fn)
    return {k: params[k] for k in ("embed", "blocks", "final_norm",
                                   "lm_head")}


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX Mixtral parameter pytree given as
    numpy arrays: the identity on names and layouts (llama's leaves without
    ``w1``/``w2``/``w3``, plus ``gate_w [L, D, E]``, ``experts_w1``/
    ``experts_w3 [L, E, D, F]`` and ``experts_w2 [L, E, F, D]``; int8
    records leaf by leaf), as :func:`gpt2.params_from_jax` copies them."""
    return gpt2.params_from_jax(tree)


def _moe_ffn(cfg: MixtralConfig, get, y, train: bool,
             rows: Optional[str] = None):
    """The block's MoE FFN (``mixtral.py:156``) on ``y [B, S, D]`` (each
    row one group): ``(out, aux)``; ``rows`` as ``moe_apply`` takes it."""
    moe_params = {"gate_w": get("gate_w"),
                  "experts": {"w1": get("experts_w1"),
                              "w3": get("experts_w3"),
                              "w2": get("experts_w2")}}
    return moe_apply(cfg.moe_cfg(), moe_params, y, train=train, rows=rows)


def _moe_block(cfg: MixtralConfig, layer: Params, x, cos, sin,
               train: bool = True):
    """Llama attention + MoE FFN (``mixtral.py:91``): ``(x, aux)``."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    get, mm = gpt2.layer_accessors(layer)
    y = L.rms_norm(x, get("attn_norm"), cfg.rms_eps)
    q = mm(y, "q_w", None).reshape(b, s, h, hd).transpose(1, 2)
    k = mm(y, "k_w", None).reshape(b, s, hkv, hd).transpose(1, 2)
    v = mm(y, "v_w", None).reshape(b, s, hkv, hd).transpose(1, 2)
    q = L.apply_rope(q, cos, sin).contiguous()
    k = L.apply_rope(k, cos, sin).contiguous()
    attn = L._attention(cfg, q, k, v.contiguous())
    attn = attn.transpose(1, 2).reshape(b, s, h * hd)
    x = x + mm(attn, "o_w", x.dtype)
    y = L.rms_norm(x, get("mlp_norm"), cfg.rms_eps)
    out, aux = _moe_ffn(cfg, get, y, train=train)
    return x + out, aux


def forward_with_aux(cfg: MixtralConfig, params: Params, input_ids,
                     train: bool = True):
    """``(logits [B, S, V], mean aux loss over the layers)``
    (``mixtral.py:115``); ``cfg.remat`` recomputes each block in the
    backward pass, and the recomputed block routes as the first pass did
    (argmax ties take the first index; top-2 gating draws no noise).
    Attention is llama's (``L._attention``: the flash kernels on CUDA,
    the KV heads unrepeated)."""
    params = gpt2._dequant_resident(params)
    s = input_ids.shape[1]
    x = params["embed"][input_ids].to(params["embed"].dtype)
    cos, sin = L.rope_angles(cfg, s, device=x.device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        layer = gpt2._layer(params["blocks"], i)
        if remat:
            from torch.utils.checkpoint import checkpoint

            x, aux = checkpoint(_moe_block, cfg, layer, x, cos, sin, train,
                                use_reentrant=False)
        else:
            x, aux = _moe_block(cfg, layer, x, cos, sin, train)
        aux_sum = aux_sum + aux
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits, aux_sum / cfg.num_layers


def loss_from_batch(cfg: MixtralConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Mean next-token cross entropy over the labels that are not -100
    plus ``router_aux_loss_coef`` times the aux loss (``mixtral.py:136``):
    the training engine's ``loss_fn``.  ``train=True`` gates at
    ``capacity_factor`` (1.25: a token past its expert's capacity drops
    from it), ``False`` at ``eval_capacity_factor``.  ``rng`` is unused,
    as in the JAX function: top-2 gating draws no noise."""
    del rng
    if isinstance(batch, (tuple, list)):
        input_ids, labels = batch
    else:
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
    if labels is None:
        labels = input_ids[:, 1:]
        input_ids = input_ids[:, :-1]
    logits, aux = forward_with_aux(cfg, params, input_ids, train=train)
    logits = logits.float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    lm_loss = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
    return lm_loss + cfg.router_aux_loss_coef * aux


def forward_cached(cfg: MixtralConfig, params: Params, input_ids, cache, pos,
                   lengths=None, block_tables=None, all_positions=False):
    """Incremental MoE forward (``mixtral.py:165``): llama's cached path
    (its position modes and cache layouts) with the MoE FFN hooked in,
    gated at ``eval_capacity_factor``, each row of the call one group.  A
    single-position step and a verify window (``all_positions``) run the
    expert products on the decode rows of ``utils.rows``, a prefill window
    on its prefill blocks."""
    t = input_ids.shape[1]
    rows = "decode" if t == 1 or all_positions else "prefill"
    return L.forward_cached(
        cfg, params, input_ids, cache, pos, lengths=lengths,
        block_tables=block_tables,
        mlp_fn=lambda get, y: _moe_ffn(cfg, get, y, train=False,
                                       rows=rows)[0],
        all_positions=all_positions)


class MixtralModel(nn.Module):
    """The ``nn.Module`` face of the functional model (``mixtral.py:193``):
    the config, the random initializer, ``loss_fn`` and
    ``flops_per_token``, and the ``decode_hooks`` the engines read.
    ``flops_per_token`` is the JAX package's ``6 * params / E * (k + 1)``:
    a token's share of the experts' parameters (k of E), plus one
    expert's worth for the attention and the rest."""

    #: the engines may store ``blocks`` (the experts included) as int8
    #: records, dequantized per layer at the point of use
    quant_aware = True
    blocks_key = ("blocks",)
    #: the inference engine draws default weights on its device in the
    #: serving dtype, quantizing each layer as it is drawn (``layer_fn``)
    init_on_device = True

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.model_config = cfg
        self.name = f"mixtral-{cfg.num_layers}l-{cfg.num_experts}e"
        self.flops_per_token = 6.0 * (cfg.num_params() / cfg.num_experts *
                                      (cfg.top_k + 1))
        self.decode_hooks = {
            "init_cache": lambda b, s, dtype=torch.bfloat16, device=None:
                L.init_cache(cfg, b, s, dtype, device),
            "forward_cached": lambda params, ids, cache, pos, lengths=None,
                block_tables=None, all_positions=False:
                forward_cached(cfg, params, ids, cache, pos, lengths,
                               block_tables, all_positions),
            "max_seq_len": cfg.max_seq_len,
            "supports_lengths": True,
            "supports_paged": True,
            "supports_verify": True,
            # the pool is read only through llama's cached attention, so
            # int8 records pass through untouched
            "supports_kv_quant": True,
            "supports_sampling": True,
        }

    def init_fn(self, generator: torch.Generator, dtype=torch.float32,
                layer_fn: Optional[Callable] = None) -> Params:
        return init_params(self.model_config, generator, dtype,
                           layer_fn=layer_fn)

    def loss_fn(self, params: Params, batch, rng=None, train: bool = True):
        return loss_from_batch(self.model_config, params, batch, rng, train)

    def forward(self, params: Params, input_ids):
        return forward_with_aux(self.model_config, params, input_ids,
                                train=False)[0]


def build(cfg: Optional[MixtralConfig] = None, **overrides) -> MixtralModel:
    return MixtralModel(cfg or MixtralConfig(**overrides))
