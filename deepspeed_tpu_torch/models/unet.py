"""Stable-Diffusion UNet (UNet2DConditionModel) — the PyTorch port of
``deepspeed_tpu/models/unet.py``: the conditioned denoiser, its training
loss and the diffusers state-dict import.

Functional over a parameter tree in the JAX layout, on the VAE's
primitives (:func:`vae.conv2d`, :func:`vae.group_norm` with eps 1e-6, the
``(0, 1)``-padded stride-2 down-sampling and the nearest 2x up-sampling):

 - the timestep embedding is ``[cos, sin]`` of ``t x 10000^(-i / half)``
   in f32, then a two-layer SiLU MLP (``unet.py:105``);
 - a resnet adds the projected ``silu(temb)`` after its first
   convolution; ``temb`` is f32, so from the first resnet on the
   activations are f32 whatever the sample's dtype (JAX's promotion of
   ``bf16 + f32``, kept here: the convolutions after it run in f32 on
   weights rounded to the compute dtype);
 - each transformer is diffusers' ``Transformer2DModel`` with one
   ``BasicTransformerBlock``: pre-LN (eps 1e-5) self-attention,
   cross-attention over the text context, and a GEGLU feed-forward whose
   gate takes ``jax.nn.gelu``'s default tanh form (diffusers uses the exact
   form; the port follows JAX);
 - the up path pops the skips in the order the down path pushed them
   (``unet.py:267``).

No TPU kernel lies on this path: convolutions are ``F.conv2d``, attention
is einsum + softmax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from . import common, gpt2
from .vae import (conv2d, conv_init, count_params, downsample, drawers,
                  gn_init, group_norm, upsample)

Params = Dict[str, Any]


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: Sequence[int] = (320, 640, 1280, 1280)
    #: True for blocks with transformer (cross-attention) layers; SD 1.x
    #: uses attention in all but the last down block
    block_has_attn: Sequence[bool] = (True, True, True, False)
    layers_per_block: int = 2
    norm_groups: int = 32
    #: head COUNT per attention layer (diffusers SD 1.x attention_head_dim=8
    #: is historically the head count: 8 heads with dims 40/80/160 per block)
    attn_heads: int = 8
    cross_attention_dim: int = 768
    sample_size: int = 64

    @staticmethod
    def sd_unet() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(block_channels=(16, 32), block_has_attn=(True, False),
                          layers_per_block=1, norm_groups=4, attn_heads=2,
                          cross_attention_dim=24, sample_size=16)

    @property
    def time_embed_dim(self) -> int:
        return self.block_channels[0] * 4

    def num_params(self) -> int:
        return count_params(init_params(self, None))


# ----------------------------------------------------------------- primitives
def _dense_init(normal, din: int, dout: int, bias: bool = True) -> Params:
    p = {"w": normal((din, dout), 1.0 / math.sqrt(din))}
    if bias:
        p["b"] = normal((dout,), 0.0)
    return p


def _dense(p: Params, x):
    return common.linear(x, p["w"], p.get("b"))


def _ln(p: Params, x):
    return gpt2._layer_norm(x, p["scale"], p["bias"])


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """diffusers ``get_timestep_embedding`` (``flip_sin_to_cos=True``,
    scale 1): ``[cos, sin]`` of ``t x exp(-ln(max_period) i / half)``, f32
    (``unet.py:105``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    ang = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _resnet_init(normal, ones, cin: int, cout: int, temb_dim: int) -> Params:
    p = {"norm1": gn_init(normal, ones, cin),
         "conv1": conv_init(normal, cin, cout, 3),
         "time_emb": _dense_init(normal, temb_dim, cout),
         "norm2": gn_init(normal, ones, cout),
         "conv2": conv_init(normal, cout, cout, 3)}
    if cin != cout:
        p["shortcut"] = conv_init(normal, cin, cout, 1)
    return p


def resnet_block(p: Params, x, temb, groups: int):
    """Resnet with the time embedding added after the first convolution
    (``unet.py:465``)."""
    h = conv2d(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)))
    h = h + _dense(p["time_emb"], F.silu(temb))[:, :, None, None]
    h = conv2d(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x, padding=0)
    return x + h


def _mha_init(normal, q_dim: int, kv_dim: int, heads: int,
              head_dim: int) -> Params:
    inner = heads * head_dim
    return {"q": _dense_init(normal, q_dim, inner, bias=False),
            "k": _dense_init(normal, kv_dim, inner, bias=False),
            "v": _dense_init(normal, kv_dim, inner, bias=False),
            "out": _dense_init(normal, inner, q_dim)}


def _einsum(eq: str, a, b):
    """``jnp.einsum``'s promotion: both operands in their common dtype (an
    f32 query over a bf16 context is an f32 product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mha(p: Params, x, context, heads: int):
    """Multi-head attention of ``x [B, N, D]`` over ``context``: scores in
    the projections' dtype, f32 softmax, probabilities cast to x's dtype
    (``unet.py:483``)."""
    b, n, _ = x.shape
    q = _dense(p["q"], x)
    k = _dense(p["k"], context)
    v = _dense(p["v"], context)
    hd = q.shape[-1] // heads
    q = q.reshape(b, n, heads, hd).transpose(1, 2)
    k = k.reshape(b, -1, heads, hd).transpose(1, 2)
    v = v.reshape(b, -1, heads, hd).transpose(1, 2)
    scores = _einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _einsum("bhqk,bhkd->bhqd", probs, v)
    return _dense(p["out"], o.transpose(1, 2).reshape(b, n, -1))


def _tx_block_init(normal, ones, dim: int, ctx_dim: int, heads: int,
                   head_dim: int) -> Params:
    return {"ln1": gn_init(normal, ones, dim),
            "attn1": _mha_init(normal, dim, dim, heads, head_dim),
            "ln2": gn_init(normal, ones, dim),
            "attn2": _mha_init(normal, dim, ctx_dim, heads, head_dim),
            "ln3": gn_init(normal, ones, dim),
            "geglu": _dense_init(normal, dim, 8 * dim),
            "ff_out": _dense_init(normal, 4 * dim, dim)}


def _tx_block(p: Params, x, context, heads: int):
    """diffusers ``BasicTransformerBlock``: self-attention, cross-attention,
    GEGLU feed-forward with ``jax.nn.gelu``'s tanh form (``unet.py:511``)."""
    y = _ln(p["ln1"], x)
    x = x + _mha(p["attn1"], y, y, heads)
    x = x + _mha(p["attn2"], _ln(p["ln2"], x), context, heads)
    a, gate = torch.chunk(_dense(p["geglu"], _ln(p["ln3"], x)), 2, dim=-1)
    return x + _dense(p["ff_out"], a * F.gelu(gate, approximate="tanh"))


def _transformer_init(normal, ones, c: int, ctx_dim: int, heads: int,
                      head_dim: int) -> Params:
    return {"norm": gn_init(normal, ones, c),
            "proj_in": conv_init(normal, c, c, 1),
            "block": _tx_block_init(normal, ones, c, ctx_dim, heads,
                                    head_dim),
            "proj_out": conv_init(normal, c, c, 1)}


def transformer_2d(p: Params, x, context, groups: int, heads: int):
    """diffusers ``Transformer2DModel`` with one ``BasicTransformerBlock``
    over the ``H * W`` positions (``unet.py:529``)."""
    b, c, h, w = x.shape
    y = conv2d(p["proj_in"], group_norm(p["norm"], x, groups), padding=0)
    y = y.reshape(b, c, h * w).transpose(1, 2)
    y = _tx_block(p["block"], y, context, heads)
    y = y.transpose(1, 2).reshape(b, c, h, w)
    return x + conv2d(p["proj_out"], y, padding=0)


# ----------------------------------------------------------------- init
def init_params(cfg: UNetConfig, generator: Optional[torch.Generator],
                dtype=torch.float32) -> Params:
    """Random parameters with the JAX ``init_params``' shapes and scales
    (``unet.py:542``), drawn on the generator's device in ``dtype``."""
    normal, ones = drawers(generator, dtype)
    chans = list(cfg.block_channels)
    temb = cfg.time_embed_dim
    heads, ctx = cfg.attn_heads, cfg.cross_attention_dim

    def tx(ch):
        return _transformer_init(normal, ones, ch, ctx, heads, ch // heads)

    p: Params = {"time_mlp1": _dense_init(normal, chans[0], temb),
                 "time_mlp2": _dense_init(normal, temb, temb),
                 "conv_in": conv_init(normal, cfg.in_channels, chans[0], 3)}
    down = []
    c = chans[0]
    for i, ch in enumerate(chans):
        blk: Params = {"resnets": []}
        if cfg.block_has_attn[i]:
            blk["attns"] = []
        for j in range(cfg.layers_per_block):
            blk["resnets"].append(_resnet_init(normal, ones,
                                               c if j == 0 else ch, ch, temb))
            if cfg.block_has_attn[i]:
                blk["attns"].append(tx(ch))
        c = ch
        if i < len(chans) - 1:
            blk["down"] = conv_init(normal, ch, ch, 3)
        down.append(blk)
    p["down"] = down
    p["mid"] = {"res1": _resnet_init(normal, ones, c, c, temb),
                "attn": tx(c),
                "res2": _resnet_init(normal, ones, c, c, temb)}
    up = []
    rev = list(reversed(chans))
    rev_attn = list(reversed(cfg.block_has_attn))
    for i, ch in enumerate(rev):
        prev_out = c
        blk = {"resnets": []}
        if rev_attn[i]:
            blk["attns"] = []
        for j in range(cfg.layers_per_block + 1):
            # skip channels: the reversed down path's outputs, conv_in's
            # last
            skip_ch = rev[min(i + 1, len(rev) - 1)] \
                if j == cfg.layers_per_block else ch
            if i == len(rev) - 1 and j == cfg.layers_per_block:
                skip_ch = chans[0]
            blk["resnets"].append(_resnet_init(normal, ones,
                                               prev_out + skip_ch, ch, temb))
            prev_out = ch
            if rev_attn[i]:
                blk["attns"].append(tx(ch))
        c = ch
        if i < len(rev) - 1:
            blk["up"] = conv_init(normal, ch, ch, 3)
        up.append(blk)
    p["up"] = up
    p["norm_out"] = gn_init(normal, ones, chans[0])
    p["conv_out"] = conv_init(normal, chans[0], cfg.out_channels, 3)
    return p


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX UNet pytree of numpy arrays (the
    identity on names, layouts and lists)."""
    return gpt2.params_from_jax(tree)


# ----------------------------------------------------------------- forward
def forward(cfg: UNetConfig, params: Params, sample, timesteps,
            encoder_hidden_states):
    """The predicted noise ``[B, out, H, W]`` of ``sample [B, in, H, W]``
    at ``timesteps [B]`` under the context ``[B, T, ctx]``
    (``unet.py:608``)."""
    g, heads = cfg.norm_groups, cfg.attn_heads
    ctx = encoder_hidden_states

    temb = timestep_embedding(timesteps, cfg.block_channels[0])
    temb = _dense(params["time_mlp2"],
                  F.silu(_dense(params["time_mlp1"], temb)))

    h = conv2d(params["conv_in"], sample)
    skips = [h]
    for blk in params["down"]:
        for j, r in enumerate(blk["resnets"]):
            h = resnet_block(r, h, temb, g)
            if "attns" in blk:
                h = transformer_2d(blk["attns"][j], h, ctx, g, heads)
            skips.append(h)
        if "down" in blk:
            h = downsample(blk["down"], h)
            skips.append(h)

    h = resnet_block(params["mid"]["res1"], h, temb, g)
    h = transformer_2d(params["mid"]["attn"], h, ctx, g, heads)
    h = resnet_block(params["mid"]["res2"], h, temb, g)

    for blk in params["up"]:
        for j, r in enumerate(blk["resnets"]):
            h = resnet_block(r, torch.cat([h, skips.pop()], dim=1), temb, g)
            if "attns" in blk:
                h = transformer_2d(blk["attns"][j], h, ctx, g, heads)
        if "up" in blk:
            h = upsample(blk["up"], h)

    h = F.silu(group_norm(params["norm_out"], h, g))
    return conv2d(params["conv_out"], h)


def loss_from_batch(cfg: UNetConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Denoising MSE: the predicted noise against ``batch["noise"]`` for
    ``batch["noisy_latents"]`` (``unet.py:657``)."""
    del rng, train
    pred = forward(cfg, params, batch["noisy_latents"], batch["timesteps"],
                   batch["encoder_hidden_states"])
    return torch.mean((pred.float() - batch["noise"].float()) ** 2)


def apply(cfg: UNetConfig, params: Params, batch):
    """``forward`` of ``{"sample", "timesteps", "encoder_hidden_states"}``
    (``unet.py:677``)."""
    return forward(cfg, params, batch["sample"], batch["timesteps"],
                   batch["encoder_hidden_states"])


# --------------------------------------------------------------------- HF I/O
def from_hf_state_dict(cfg: UNetConfig, sd: Dict[str, Any]) -> Params:
    """A diffusers ``UNet2DConditionModel`` state dict -> the parameter
    tree (``unet.py:692``: ``time_embedding.linear_{1,2}``,
    ``down_blocks.N.resnets.M.{norm1,conv1,time_emb_proj,...}``,
    ``.attentions.M.transformer_blocks.0.{attn1,attn2,ff.net.0.proj,
    ff.net.2}``, ``mid_block``, ``up_blocks``, ``conv_norm_out`` /
    ``conv_out``), float32 CPU tensors."""
    get = common.hf_getter(sd, ("",), "UNet")
    t = common.hf_tensor

    def conv(name):
        return {"w": t(get(name + ".weight")), "b": t(get(name + ".bias"))}

    def gn(name):
        return {"scale": t(get(name + ".weight")),
                "bias": t(get(name + ".bias"))}

    def dense(name, bias=True):
        p = {"w": t(get(name + ".weight").T)}
        if bias:
            p["b"] = t(get(name + ".bias"))
        return p

    def resnet(prefix):
        p = {"norm1": gn(prefix + ".norm1"), "conv1": conv(prefix + ".conv1"),
             "time_emb": dense(prefix + ".time_emb_proj"),
             "norm2": gn(prefix + ".norm2"), "conv2": conv(prefix + ".conv2")}
        if prefix + ".conv_shortcut.weight" in sd:
            p["shortcut"] = conv(prefix + ".conv_shortcut")
        return p

    def mha(prefix):
        return {"q": dense(prefix + ".to_q", bias=False),
                "k": dense(prefix + ".to_k", bias=False),
                "v": dense(prefix + ".to_v", bias=False),
                "out": dense(prefix + ".to_out.0")}

    def tx(prefix):
        b = prefix + ".transformer_blocks.0"
        return {"norm": gn(prefix + ".norm"),
                "proj_in": conv(prefix + ".proj_in"),
                "block": {"ln1": gn(b + ".norm1"), "attn1": mha(b + ".attn1"),
                          "ln2": gn(b + ".norm2"), "attn2": mha(b + ".attn2"),
                          "ln3": gn(b + ".norm3"),
                          "geglu": dense(b + ".ff.net.0.proj"),
                          "ff_out": dense(b + ".ff.net.2")},
                "proj_out": conv(prefix + ".proj_out")}

    def blocks(kind, has_attn, n_res, sampler, key):
        out = []
        for i, attn in enumerate(has_attn):
            blk: Params = {"resnets": [resnet(f"{kind}.{i}.resnets.{j}")
                                       for j in range(n_res)]}
            if attn:
                blk["attns"] = [tx(f"{kind}.{i}.attentions.{j}")
                                for j in range(n_res)]
            name = f"{kind}.{i}.{sampler}.0.conv"
            if name + ".weight" in sd:
                blk[key] = conv(name)
            out.append(blk)
        return out

    return {
        "time_mlp1": dense("time_embedding.linear_1"),
        "time_mlp2": dense("time_embedding.linear_2"),
        "conv_in": conv("conv_in"),
        "down": blocks("down_blocks", cfg.block_has_attn,
                       cfg.layers_per_block, "downsamplers", "down"),
        "mid": {"res1": resnet("mid_block.resnets.0"),
                "attn": tx("mid_block.attentions.0"),
                "res2": resnet("mid_block.resnets.1")},
        "up": blocks("up_blocks", list(reversed(cfg.block_has_attn)),
                     cfg.layers_per_block + 1, "upsamplers", "up"),
        "norm_out": gn("conv_norm_out"),
        "conv_out": conv("conv_out"),
    }


def build(cfg: Optional[UNetConfig] = None, **overrides
          ) -> common.FunctionalModel:
    import sys

    cfg = cfg or UNetConfig(**overrides)
    return common.FunctionalModel(cfg, sys.modules[__name__],
                                  f"unet-{cfg.block_channels[0]}c")
