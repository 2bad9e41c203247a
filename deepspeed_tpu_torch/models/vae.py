"""Stable-Diffusion VAE (AutoencoderKL) — the PyTorch port of
``deepspeed_tpu/models/vae.py``: the encoder, decoder, latent sampling,
training loss and the diffusers state-dict import.

Functional over a parameter tree in the JAX layout (NCHW activations,
``[O, I, kh, kw]`` convolution weights, ``[in, out]`` dense weights; the
down and up blocks and their resnets are lists, as the JAX pytree's).
The primitives are shared with ``models/unet.py``:

 - :func:`conv2d` casts the weight and bias to the input's dtype and adds
   the bias after the convolution (``vae.py:69``), so an f32 input runs
   f32 convolutions on bf16-rounded weights;
 - :func:`group_norm` takes population statistics over ``(C/G, H, W)``
   in f32 with eps 1e-6 and casts back (``vae.py:78``);
 - the stride-2 down-sampling pads ``(0, 1)`` on H and W and runs a valid
   convolution (``vae.py:197``), the up-sampling repeats each pixel 2x2
   (``jax.image.resize`` "nearest" at exactly 2x).

No TPU kernel lies on this path (the JAX file reaches no ``pallas_call``):
convolutions are ``F.conv2d``, attention is matmul + softmax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import common, gpt2

Params = Dict[str, Any]


@dataclasses.dataclass
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Sequence[int] = (1, 2, 4, 4)
    layers_per_block: int = 2
    norm_groups: int = 32
    sample_size: int = 256
    scaling_factor: float = 0.18215

    @staticmethod
    def sd_vae() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(base_channels=16, channel_mults=(1, 2),
                         layers_per_block=1, norm_groups=4, sample_size=32,
                         latent_channels=4)

    def num_params(self) -> int:
        return count_params(init_params(self, None))


# ----------------------------------------------------------------- drawing
def drawers(generator: Optional[torch.Generator], dtype=torch.float32):
    """``(normal(shape, std), ones(shape))`` on the generator's device, as
    :func:`common.drawers`; ``generator=None`` gives meta tensors (shapes
    only, for :func:`count_params`)."""
    if generator is not None:
        return common.drawers(generator, dtype)

    def empty(shape, s=1.0):
        return torch.empty(shape, dtype=dtype, device="meta")
    return empty, empty


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()


def conv_init(normal, cin: int, cout: int, k: int) -> Params:
    """``[O, I, k, k]`` weights of std ``1 / sqrt(I k k)``, zero bias
    (``vae.py:63``)."""
    return {"w": normal((cout, cin, k, k), 1.0 / math.sqrt(cin * k * k)),
            "b": normal((cout,), 0.0)}


def gn_init(normal, ones, c: int) -> Params:
    return {"scale": ones((c,)), "bias": normal((c,), 0.0)}


# ----------------------------------------------------------------- primitives
def conv2d(p: Params, x, stride: int = 1, padding: int = 1):
    """x: ``[B, C, H, W]``; weight ``[O, I, kh, kw]``, both cast to x's
    dtype; the bias added after the convolution, as ``vae.py:69``."""
    out = F.conv2d(x, p["w"].to(x.dtype), None, stride, padding)
    return out + p["b"].to(x.dtype)[None, :, None, None]


def group_norm(p: Params, x, groups: int, eps: float = 1e-6):
    """Group norm with f32 population statistics over ``(C/G, H, W)``, the
    f32 scale and bias, cast back to x's dtype (``vae.py:78``)."""
    return F.group_norm(x.float(), groups, p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def downsample(p: Params, x):
    """diffusers' down-sampler: pad ``(0, 1)`` on H and W (last dim first
    in ``F.pad``), then a stride-2 valid convolution (``vae.py:197``)."""
    return conv2d(p, F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)


def upsample(p: Params, x):
    """Nearest 2x (``jax.image.resize(..., "nearest")``: output pixel ``i``
    reads input ``i // 2``), then a 3x3 convolution."""
    return conv2d(p, F.interpolate(x, scale_factor=2, mode="nearest"))


def resnet_init(normal, ones, cin: int, cout: int) -> Params:
    p = {"norm1": gn_init(normal, ones, cin),
         "conv1": conv_init(normal, cin, cout, 3),
         "norm2": gn_init(normal, ones, cout),
         "conv2": conv_init(normal, cout, cout, 3)}
    if cin != cout:
        p["shortcut"] = conv_init(normal, cin, cout, 1)
    return p


def resnet_block(p: Params, x, groups: int):
    h = conv2d(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)))
    h = conv2d(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x, padding=0)
    return x + h


def _attn_init(normal, ones, c: int) -> Params:
    def dense():
        return {"w": normal((c, c), 1.0 / math.sqrt(c)),
                "b": normal((c,), 0.0)}
    return {"norm": gn_init(normal, ones, c), "q": dense(), "k": dense(),
            "v": dense(), "proj": dense()}


def attention_block(p: Params, x, groups: int):
    """Single-head spatial self-attention over the ``H * W`` positions
    (``vae.py:121``): scores in x's dtype, then f32 softmax, probabilities
    cast back."""
    b, c, hh, ww = x.shape
    h = group_norm(p["norm"], x, groups)
    flat = h.reshape(b, c, hh * ww).transpose(1, 2)          # [B, HW, C]
    q, k, v = (common.linear(flat, p[n]["w"], p[n]["b"])
               for n in ("q", "k", "v"))
    scores = (q @ k.transpose(1, 2)).float() / math.sqrt(c)
    probs = torch.softmax(scores, dim=-1).to(flat.dtype)
    o = common.linear(probs @ v, p["proj"]["w"], p["proj"]["b"])
    return x + o.transpose(1, 2).reshape(b, c, hh, ww)


# ----------------------------------------------------------------- init
def init_params(cfg: VAEConfig, generator: Optional[torch.Generator],
                dtype=torch.float32) -> Params:
    """Random parameters with the JAX ``init_params``' shapes and scales
    (``vae.py:137``), drawn on the generator's device in ``dtype``."""
    normal, ones = drawers(generator, dtype)
    chans = [cfg.base_channels * m for m in cfg.channel_mults]
    g2 = 2 * cfg.latent_channels

    enc: Params = {"conv_in": conv_init(normal, cfg.in_channels, chans[0],
                                        3)}
    down = []
    c = chans[0]
    for i, ch in enumerate(chans):
        blk: Params = {"resnets": [
            resnet_init(normal, ones, c if j == 0 else ch, ch)
            for j in range(cfg.layers_per_block)]}
        c = ch
        if i < len(chans) - 1:
            blk["down"] = conv_init(normal, ch, ch, 3)
        down.append(blk)
    enc["down"] = down
    enc["mid"] = _mid_init(normal, ones, c)
    enc["norm_out"] = gn_init(normal, ones, c)
    enc["conv_out"] = conv_init(normal, c, g2, 3)

    dec: Params = {"conv_in": conv_init(normal, cfg.latent_channels, c, 3),
                   "mid": _mid_init(normal, ones, c)}
    up = []
    for i, ch in enumerate(reversed(chans)):
        blk = {"resnets": [
            resnet_init(normal, ones, c if j == 0 else ch, ch)
            for j in range(cfg.layers_per_block + 1)]}
        c = ch
        if i < len(chans) - 1:
            blk["up"] = conv_init(normal, ch, ch, 3)
        up.append(blk)
    dec["up"] = up
    dec["norm_out"] = gn_init(normal, ones, c)
    dec["conv_out"] = conv_init(normal, c, cfg.in_channels, 3)
    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv_init(normal, g2, g2, 1),
            "post_quant_conv": conv_init(normal, cfg.latent_channels,
                                         cfg.latent_channels, 1)}


def _mid_init(normal, ones, c: int) -> Params:
    return {"res1": resnet_init(normal, ones, c, c),
            "attn": _attn_init(normal, ones, c),
            "res2": resnet_init(normal, ones, c, c)}


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX VAE pytree of numpy arrays (the
    identity on names, layouts and lists)."""
    return gpt2.params_from_jax(tree)


# ----------------------------------------------------------------- forward
def _mid(p: Params, h, g: int):
    h = resnet_block(p["res1"], h, g)
    h = attention_block(p["attn"], h, g)
    return resnet_block(p["res2"], h, g)


def encode(cfg: VAEConfig, params: Params, x):
    """x: ``[B, 3, H, W]`` -> ``(mean, logvar)``, each ``[B, latent, H /
    2^d, W / 2^d]``, logvar clipped to ``[-30, 20]`` (``vae.py:187``)."""
    p = params["encoder"]
    g = cfg.norm_groups
    h = conv2d(p["conv_in"], x)
    for blk in p["down"]:
        for r in blk["resnets"]:
            h = resnet_block(r, h, g)
        if "down" in blk:
            h = downsample(blk["down"], h)
    h = _mid(p["mid"], h, g)
    h = conv2d(p["conv_out"], F.silu(group_norm(p["norm_out"], h, g)))
    h = conv2d(params["quant_conv"], h, padding=0)
    mean, logvar = torch.chunk(h, 2, dim=1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def decode(cfg: VAEConfig, params: Params, z):
    """Latents ``[B, latent, h, w]`` -> images ``[B, 3, h 2^d, w 2^d]``
    (``vae.py:212``)."""
    p = params["decoder"]
    g = cfg.norm_groups
    h = conv2d(params["post_quant_conv"], z, padding=0)
    h = conv2d(p["conv_in"], h)
    h = _mid(p["mid"], h, g)
    for blk in p["up"]:
        for r in blk["resnets"]:
            h = resnet_block(r, h, g)
        if "up" in blk:
            h = upsample(blk["up"], h)
    return conv2d(p["conv_out"], F.silu(group_norm(p["norm_out"], h, g)))


def _key(rng, device) -> torch.Tensor:
    """A JAX-layout key (int64 tensor, numpy or JAX uint32 pair) as an
    int64 tensor on ``device``."""
    key = rng if isinstance(rng, torch.Tensor) else \
        torch.from_numpy(np.asarray(rng).astype(np.int64))
    return key.to(device=device, dtype=torch.int64)


def sample_latent(mean, logvar, rng):
    """``mean + exp(logvar / 2) * jax.random.normal(rng, mean.shape)``
    (``vae.py:231``): the f32 draw of ``ops/sampling.normal`` on the
    latents' device promotes a 16-bit mean to f32, as in JAX."""
    from ..ops.sampling import normal

    eps = normal(_key(rng, mean.device), mean.shape)
    return mean + torch.exp(0.5 * logvar) * eps


def loss_from_batch(cfg: VAEConfig, params: Params, batch, rng=None,
                    train: bool = True, kl_weight: float = 1e-6):
    """Reconstruction MSE + ``kl_weight`` x KL (``vae.py:235``): the latent
    is sampled with ``rng`` when training, else the mean."""
    x = batch["pixel_values"] if isinstance(batch, dict) else batch
    mean, logvar = encode(cfg, params, x)
    z = sample_latent(mean, logvar, rng) if (train and rng is not None) \
        else mean
    recon = decode(cfg, params, z)
    rec = torch.mean((recon.float() - x.float()) ** 2)
    m, lv = mean.float(), logvar.float()
    kl = 0.5 * torch.mean(m ** 2 + torch.exp(lv) - 1.0 - lv)
    return rec + kl_weight * kl


def apply(cfg: VAEConfig, params: Params, batch):
    """Encode to the mean latent and decode it (``vae.py:334``)."""
    x = batch["pixel_values"] if isinstance(batch, dict) else batch
    mean, _ = encode(cfg, params, x)
    return decode(cfg, params, mean)


# ----------------------------------------------------------------- HF I/O
def from_hf_state_dict(cfg: VAEConfig, sd: Dict[str, Any]) -> Params:
    """A diffusers ``AutoencoderKL`` state dict -> the parameter tree
    (``vae.py:257``: ``encoder.down_blocks.N.resnets.M.{norm1,conv1,...}``,
    ``mid_block.attentions.0.to_{q,k,v,out.0}`` (1x1-conv attention
    projections of old checkpoints squeezed), ``decoder.up_blocks...``,
    ``quant_conv`` / ``post_quant_conv``), float32 CPU tensors."""
    get = common.hf_getter(sd, ("",), "VAE")
    t = common.hf_tensor

    def conv(name):
        return {"w": t(get(name + ".weight")), "b": t(get(name + ".bias"))}

    def gn(name):
        return {"scale": t(get(name + ".weight")),
                "bias": t(get(name + ".bias"))}

    def dense(name):
        w = get(name + ".weight")
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        return {"w": t(w.T), "b": t(get(name + ".bias"))}

    def resnet(prefix):
        p = {"norm1": gn(prefix + ".norm1"), "conv1": conv(prefix + ".conv1"),
             "norm2": gn(prefix + ".norm2"), "conv2": conv(prefix + ".conv2")}
        if prefix + ".conv_shortcut.weight" in sd:
            p["shortcut"] = conv(prefix + ".conv_shortcut")
        return p

    def mid(prefix):
        a = prefix + ".attentions.0"
        return {"res1": resnet(prefix + ".resnets.0"),
                "attn": {"norm": gn(a + ".group_norm"),
                         "q": dense(a + ".to_q"), "k": dense(a + ".to_k"),
                         "v": dense(a + ".to_v"),
                         "proj": dense(a + ".to_out.0")},
                "res2": resnet(prefix + ".resnets.1")}

    def blocks(side, kind, n_res, sampler, key):
        out = []
        for i in range(len(cfg.channel_mults)):
            blk = {"resnets": [resnet(f"{side}.{kind}.{i}.resnets.{j}")
                               for j in range(n_res)]}
            name = f"{side}.{kind}.{i}.{sampler}.0.conv"
            if name + ".weight" in sd:
                blk[key] = conv(name)
            out.append(blk)
        return out

    enc = {"conv_in": conv("encoder.conv_in"),
           "down": blocks("encoder", "down_blocks", cfg.layers_per_block,
                          "downsamplers", "down"),
           "mid": mid("encoder.mid_block"),
           "norm_out": gn("encoder.conv_norm_out"),
           "conv_out": conv("encoder.conv_out")}
    dec = {"conv_in": conv("decoder.conv_in"),
           "mid": mid("decoder.mid_block"),
           "up": blocks("decoder", "up_blocks", cfg.layers_per_block + 1,
                        "upsamplers", "up"),
           "norm_out": gn("decoder.conv_norm_out"),
           "conv_out": conv("decoder.conv_out")}
    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv("quant_conv"),
            "post_quant_conv": conv("post_quant_conv")}


def build(cfg: Optional[VAEConfig] = None, **overrides
          ) -> common.FunctionalModel:
    import sys

    cfg = cfg or VAEConfig(**overrides)
    return common.FunctionalModel(cfg, sys.modules[__name__],
                                  f"vae-{cfg.base_channels}c")
