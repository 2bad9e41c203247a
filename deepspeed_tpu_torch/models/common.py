"""What the model families share and none of them owns: the random
drawers, the batch split and cross entropy of ``loss_from_batch``, the
HuggingFace state-dict readers, the contiguous KV workspace, einsum causal
attention, the layer loop, the ``nn.Module`` of the contiguous-cache
families (GPT-NeoX, GPT-J, GPT-Neo) and that of the families served by
``forward(batch)`` alone (BERT, CLIP, the VAE and the UNet)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from . import gpt2

Params = Dict[str, Any]


def to_np(t) -> np.ndarray:
    """A tensor (bfloat16 included) or an array as a float32 numpy
    array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def drawers(generator: torch.Generator, dtype, device=None):
    """``(normal(shape, std), ones(shape))`` for the families drawn layer
    by layer on the generator's device (OPT, BLOOM, GPT-NeoX, GPT-J,
    GPT-Neo): float32 draws stored in ``dtype``, std 0.0 giving zeros."""
    dev = generator.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"init_params draws on the generator's device "
                         f"{dev}, not {device}")

    def normal(shape, s=0.02):
        if s == 0.0:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return (torch.randn(shape, generator=generator, device=dev) * s
                ).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return normal, ones


def split_batch(batch):
    """``(input_ids, labels)`` of a batch as ``loss_from_batch`` takes it:
    ``{"input_ids"[, "labels"]}`` or a pair; labels default to the ids
    shifted by one."""
    if isinstance(batch, (tuple, list)):
        input_ids, labels = batch
    else:
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
    if labels is None:
        labels = input_ids[:, 1:]
        input_ids = input_ids[:, :-1]
    return input_ids, labels


def ce_from_logits(logits, targets):
    """``lse - picked logit`` mean cross entropy over the targets that are
    not -100 (the JAX families' ``loss_from_batch``)."""
    valid = targets >= 0
    safe = torch.where(valid, targets, 0)
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0].float()
    return torch.where(valid, lse - picked, 0.0).sum() / \
        valid.sum().clamp(min=1)


def linear(x, w, b=None):
    """``x @ w (+ b)`` with the weights cast to x's dtype (the JAX
    families' ``x @ p["w"].astype(x.dtype)``)."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def hf_getter(sd: Dict[str, Any], prefixes, family: str):
    """``get(name)``: ``sd[prefix + name]`` for the first of ``prefixes``
    that has it, as a float32 numpy array (:func:`to_np`)."""
    def get(name):
        for prefix in prefixes:
            if prefix + name in sd:
                return to_np(sd[prefix + name])
        raise KeyError(f"missing {family} weight {name!r}; have "
                       f"{sorted(sd)[:8]}...")
    return get


def hf_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor (contiguous)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def hf_stacker(get, num_layers: int):
    """``stack(fmt, fn)``: the ``[L, ...]`` float32 tensor of
    ``fn(get(fmt.format(i=i)))`` over the layers."""
    def stack(fmt, fn=lambda x: x):
        return hf_tensor(np.stack([fn(get(fmt.format(i=i)))
                                   for i in range(num_layers)]))
    return stack


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Static KV workspace ``[L, B, H, S, hd]``; with ``batch_size =
    num_blocks`` and ``max_len = block_size`` it is a paged pool."""
    shape = (cfg.num_layers, batch_size, cfg.num_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def split_heads(cfg, qkv):
    """q, k, v ``[B, H, T, hd]`` (contiguous) of a fused ``[B, T, 3D]``
    projection laid out q | k | v."""
    b, t, _ = qkv.shape
    return [z.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
            .contiguous() for z in qkv.chunk(3, dim=-1)]


def inv_freq(rot: int, theta: float, device):
    """Rotary inverse frequencies ``theta ** (-2i / rot)``, f32."""
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def causal_attention(q, k, v, scale: Optional[float], q_offset: int = 0,
                     window: Optional[int] = None):
    """Einsum attention of ``q [B, H, Sq, hd]`` over ``k``/``v [B, H, Sk,
    hd]``, query ``i`` at position ``q_offset + i`` seeing keys at
    positions ``<=`` its own (and ``> pos - window`` with a local
    ``window``): scores in q's dtype (divided by ``scale`` unless None),
    masked and softmaxed in f32, probabilities cast back
    (``gptneox.py:138``)."""
    sq, sk = q.shape[2], k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if scale is not None:
        scores = scores / scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def run_layers(cfg, params: Params, x, block):
    """``block(cfg, x, layer)`` over the stacked layers (``lax.scan`` in
    JAX), each recomputed in the backward under ``cfg.remat``."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        layer = gpt2._layer(params["blocks"], i)
        if remat:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(block, cfg, x, layer, use_reentrant=False)
        else:
            x = block(cfg, x, layer)
    return x


class DecoderModel(nn.Module):
    """The ``nn.Module`` face shared by GPT-NeoX, GPT-J and GPT-Neo: the
    config, the random initializer, ``loss_fn``, ``flops_per_token`` and
    the ``decode_hooks`` of contiguous-cache generation (``generate``; the
    JAX families declare no paged serving).  ``family`` is the model's
    module."""

    quant_aware = True
    blocks_key = ("blocks",)
    init_on_device = True

    def __init__(self, cfg, family, name: str):
        super().__init__()
        if cfg.dropout:
            raise NotImplementedError(
                f"{name}: dropout is not implemented (the forward ignores "
                "it); set dropout=0")
        self.model_config = cfg
        self._family = family
        self.name = f"{name}-{cfg.num_layers}l-{cfg.hidden_size}d"
        self.flops_per_token = 6.0 * cfg.num_params()
        self.decode_hooks = {
            "init_cache": lambda b, s, dtype=torch.bfloat16, device=None:
                family.init_cache(cfg, b, s, dtype, device),
            "forward_cached": lambda params, ids, cache, pos:
                family.forward_cached(cfg, params, ids, cache, pos),
            "max_seq_len": cfg.max_seq_len,
        }

    def init_fn(self, generator: torch.Generator, dtype=torch.float32,
                layer_fn: Optional[Callable] = None) -> Params:
        return self._family.init_params(self.model_config, generator, dtype,
                                        layer_fn=layer_fn)

    def loss_fn(self, params: Params, batch, rng=None, train: bool = True):
        return self._family.loss_from_batch(self.model_config, params, batch,
                                            rng, train)

    def forward(self, params: Params, input_ids):
        return self._family.forward(self.model_config, params, input_ids)


class FunctionalModel(nn.Module):
    """The ``nn.Module`` face of the encoder and diffusion families (BERT,
    CLIP, the VAE, the UNet): the config, the random initializer (drawn
    on the generator's device), ``loss_fn`` and ``apply_fn(params,
    batch)``, which the inference engine's ``forward`` calls on the whole
    batch.  They decode nothing: no ``decode_hooks``, so ``generate`` and
    ``init_serving`` refuse them.  ``family`` is the model's module (its
    ``init_params``, ``loss_from_batch`` and ``apply``)."""

    quant_aware = False
    decode_hooks = None
    init_on_device = True

    def __init__(self, cfg, family, name: str,
                 flops_per_token: Optional[float] = None):
        super().__init__()
        self.model_config = cfg
        self._family = family
        self.name = name
        self.flops_per_token = flops_per_token

    def init_fn(self, generator: torch.Generator,
                dtype=torch.float32) -> Params:
        return self._family.init_params(self.model_config, generator, dtype)

    def loss_fn(self, params: Params, batch, rng=None, train: bool = True):
        return self._family.loss_from_batch(self.model_config, params, batch,
                                            rng, train)

    def apply_fn(self, params: Params, batch):
        return self._family.apply(self.model_config, params, batch)

    def forward(self, params: Params, batch):
        return self.apply_fn(params, batch)
