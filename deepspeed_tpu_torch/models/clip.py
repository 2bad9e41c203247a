"""CLIP dual-tower encoder — the PyTorch port of
``deepspeed_tpu/models/clip.py``: the text and vision towers, the
similarity logits, the symmetric InfoNCE loss and the HuggingFace
``CLIPModel`` state-dict import.

Functional over a parameter tree in the JAX layout (each tower's blocks
stacked ``[L, ...]``, ``[in, out]`` weights, q | k | v fused).  Pre-LN
``CLIPEncoderLayer`` blocks (eps 1e-5, statistics in f32) with
quick-GELU; scores in the activations' dtype, then f32 (masked causally
in the text tower) for the softmax.  The text tower pools the first
``eos_token_id`` position, or the argmax of the ids when the config has
none (``clip.py:206``); the vision tower patchifies by a reshape and one
``[3 p p, D]`` matmul, not a convolution (``clip.py:216``), then prepends
the class token.  No TPU kernel lies on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import common, gpt2

Params = Dict[str, Any]


@dataclasses.dataclass
class CLIPConfig:
    # text tower
    vocab_size: int = 49408
    text_seq_len: int = 77
    text_layers: int = 12
    text_heads: int = 8
    text_width: int = 512
    text_ffn: int = 2048
    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_layers: int = 12
    vision_heads: int = 12
    vision_width: int = 768
    vision_ffn: int = 3072
    # joint space
    projection_dim: int = 512
    logit_scale_init: float = 2.6592
    #: text pooling position: first occurrence of this token id; None =
    #: highest-id token (argmax — the original CLIP convention)
    eos_token_id: Optional[int] = 49407

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_b_32() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def tiny() -> "CLIPConfig":
        return CLIPConfig(vocab_size=96, text_seq_len=16, text_layers=2,
                          text_heads=4, text_width=32, text_ffn=64,
                          image_size=32, patch_size=16, vision_layers=2,
                          vision_heads=4, vision_width=48, vision_ffn=96,
                          projection_dim=24)

    @staticmethod
    def from_hf(hf) -> "CLIPConfig":
        """Translate a ``transformers.CLIPConfig`` or its ``config.json``
        (``clip.py:415``): an OpenAI config's ``eos_token_id`` of 2 (a
        bos id never emitted; HF's legacy branch pools at the argmax of
        the ids) maps to ``None``."""
        t, v = hf.text_config, hf.vision_config
        return CLIPConfig(
            vocab_size=t.vocab_size, text_seq_len=t.max_position_embeddings,
            text_layers=t.num_hidden_layers, text_heads=t.num_attention_heads,
            text_width=t.hidden_size, text_ffn=t.intermediate_size,
            image_size=v.image_size, patch_size=v.patch_size,
            vision_layers=v.num_hidden_layers,
            vision_heads=v.num_attention_heads,
            vision_width=v.hidden_size, vision_ffn=v.intermediate_size,
            projection_dim=hf.projection_dim,
            logit_scale_init=hf.logit_scale_init_value,
            # a config.json drops an id equal to CLIPTextConfig's default
            eos_token_id=(None if getattr(t, "eos_token_id", 49407) == 2
                          else getattr(t, "eos_token_id", 49407)))

    def num_params(self) -> int:
        def tower(l, d, f, extra):
            per = 4 * (d * d + d) + (d * f + f) + (f * d + d) + 4 * d
            return l * per + extra

        text = tower(self.text_layers, self.text_width, self.text_ffn,
                     (self.vocab_size + self.text_seq_len) * self.text_width +
                     2 * self.text_width)
        d = self.vision_width
        vision = tower(self.vision_layers, d, self.vision_ffn,
                       (3 * self.patch_size ** 2) * d + d +
                       (self.num_patches + 1) * d + 4 * d)
        proj = (self.text_width + self.vision_width) * self.projection_dim + 1
        return text + vision + proj


def _tower_init(normal, ones, l: int, d: int, f: int) -> Params:
    return {
        "ln1_scale": ones((l, d)), "ln1_bias": normal((l, d), 0.0),
        "qkv_w": normal((l, d, 3 * d)), "qkv_b": normal((l, 3 * d), 0.0),
        "o_w": normal((l, d, d)), "o_b": normal((l, d), 0.0),
        "ln2_scale": ones((l, d)), "ln2_bias": normal((l, d), 0.0),
        "fc_w": normal((l, d, f)), "fc_b": normal((l, f), 0.0),
        "proj_w": normal((l, f, d)), "proj_b": normal((l, d), 0.0),
    }


def init_params(cfg: CLIPConfig, generator: torch.Generator,
                dtype=torch.float32) -> Params:
    """Random parameters with the JAX ``init_params``' shapes and scales
    (``clip.py:462``: std 0.02, zero biases, unit LN scales, the logit
    scale at ``logit_scale_init``), drawn on the generator's device."""
    normal, ones = common.drawers(generator, dtype)
    dt, dv = cfg.text_width, cfg.vision_width
    return {
        "text": {
            "tok_emb": normal((cfg.vocab_size, dt)),
            "pos_emb": normal((cfg.text_seq_len, dt)),
            "blocks": _tower_init(normal, ones, cfg.text_layers, dt,
                                  cfg.text_ffn),
            "lnf_scale": ones((dt,)), "lnf_bias": normal((dt,), 0.0),
        },
        "vision": {
            "patch_w": normal((3 * cfg.patch_size ** 2, dv)),
            "class_emb": normal((dv,)),
            "pos_emb": normal((cfg.num_patches + 1, dv)),
            "pre_ln_scale": ones((dv,)), "pre_ln_bias": normal((dv,), 0.0),
            "blocks": _tower_init(normal, ones, cfg.vision_layers, dv,
                                  cfg.vision_ffn),
            "post_ln_scale": ones((dv,)), "post_ln_bias": normal((dv,), 0.0),
        },
        "text_projection": normal((dt, cfg.projection_dim)),
        "visual_projection": normal((dv, cfg.projection_dim)),
        "logit_scale": torch.full((), cfg.logit_scale_init, dtype=dtype,
                                  device=generator.device),
    }


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX CLIP pytree of numpy arrays (the
    identity on names and layouts)."""
    return gpt2.params_from_jax(tree)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _block(x, layer: Params, heads: int, causal: bool):
    """One pre-LN ``CLIPEncoderLayer`` (``clip.py:503``)."""
    b, s, d = x.shape
    hd = d // heads
    y = gpt2._layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    q, k, v = (z.reshape(b, s, heads, hd).transpose(1, 2)
               for z in common.linear(y, layer["qkv_w"], layer["qkv_b"])
               .chunk(3, dim=-1))
    scores = (torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)).float()
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    x = x + common.linear(attn.transpose(1, 2).reshape(b, s, d), layer["o_w"],
                    layer["o_b"])
    y = gpt2._layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    hid = _quick_gelu(common.linear(y, layer["fc_w"], layer["fc_b"]))
    return x + common.linear(hid, layer["proj_w"], layer["proj_b"])


def _run_tower(x, blocks: Params, layers: int, heads: int, causal: bool):
    for i in range(layers):
        x = _block(x, gpt2._layer(blocks, i), heads, causal)
    return x


def pool_positions(cfg: CLIPConfig, input_ids):
    """The pooled position of each text row: the first ``eos_token_id``,
    else the highest id (``clip.py:549``; argmax takes the first of
    ties)."""
    if cfg.eos_token_id is not None:
        return torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32),
                            dim=-1)
    return torch.argmax(input_ids, dim=-1)


def encode_text(cfg: CLIPConfig, params: Params, input_ids):
    """Pooled, projected text embeddings ``[B, P]`` (``clip.py:539``)."""
    p = params["text"]
    s = input_ids.shape[1]
    x = (p["tok_emb"][input_ids] + p["pos_emb"][:s]).to(p["tok_emb"].dtype)
    x = _run_tower(x, p["blocks"], cfg.text_layers, cfg.text_heads,
                   causal=True)
    x = gpt2._layer_norm(x, p["lnf_scale"], p["lnf_bias"])
    pooled = x[torch.arange(x.shape[0], device=x.device),
               pool_positions(cfg, input_ids)]
    return pooled @ params["text_projection"].to(pooled.dtype)


def _patchify(pixel_values, patch: int):
    """``[B, 3, H, W]`` -> ``[B, patches, 3 p p]``, each patch flattened
    channel-major as a ``Conv2d(stride=patch)`` kernel is
    (``clip.py:558``)."""
    b, c, h, w = pixel_values.shape
    gh, gw = h // patch, w // patch
    x = pixel_values.reshape(b, c, gh, patch, gw, patch)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * patch * patch)


def encode_image(cfg: CLIPConfig, params: Params, pixel_values):
    """Pooled, projected image embeddings ``[B, P]`` (``clip.py:568``)."""
    p = params["vision"]
    x = _patchify(pixel_values, cfg.patch_size).to(p["patch_w"].dtype) @ \
        p["patch_w"]
    cls = p["class_emb"].expand(x.shape[0], 1, x.shape[-1]).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p["pos_emb"].to(x.dtype)
    x = gpt2._layer_norm(x, p["pre_ln_scale"], p["pre_ln_bias"])
    x = _run_tower(x, p["blocks"], cfg.vision_layers, cfg.vision_heads,
                   causal=False)
    pooled = gpt2._layer_norm(x[:, 0], p["post_ln_scale"], p["post_ln_bias"])
    return pooled @ params["visual_projection"].to(pooled.dtype)


def forward(cfg: CLIPConfig, params: Params, batch):
    """``(logits_per_image, logits_per_text)``, each ``[B, B]`` f32: the
    scaled cosine similarities (``clip.py:582``)."""
    text = encode_text(cfg, params, batch["input_ids"])
    image = encode_image(cfg, params, batch["pixel_values"])
    text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    image = image / torch.linalg.vector_norm(image, dim=-1, keepdim=True)
    scale = torch.exp(params["logit_scale"])
    logits_per_text = (text @ image.t()).float() * scale
    return logits_per_text.t(), logits_per_text


def loss_from_batch(cfg: CLIPConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Symmetric InfoNCE over the in-batch pairs (``clip.py:593``)."""
    del rng, train
    logits_per_image, logits_per_text = forward(cfg, params, batch)
    labels = torch.arange(logits_per_text.shape[0],
                          device=logits_per_text.device)

    def ce(logits):
        lse = torch.logsumexp(logits, dim=-1)
        return (lse - logits.gather(-1, labels[:, None])[:, 0]).mean()

    return 0.5 * (ce(logits_per_text) + ce(logits_per_image))


def apply(cfg: CLIPConfig, params: Params, batch):
    """``forward`` of ``{"input_ids", "pixel_values"}`` (``clip.py:727``)."""
    return forward(cfg, params, batch)


# --------------------------------------------------------------------- HF I/O
def _tower_from_hf(get, prefix: str, l: int) -> Params:  # noqa: E741
    t = common.hf_tensor

    def stack(fmt, fn=lambda x: x):
        return t(np.stack([fn(get(prefix + fmt.format(i=i)))
                           for i in range(l)]))

    def qkv(kind, fn):
        return t(np.stack([np.concatenate(
            [fn(get(f"{prefix}layers.{i}.self_attn.{p}_proj.{kind}"))
             for p in ("q", "k", "v")], axis=-1) for i in range(l)]))

    tr = lambda w: w.T  # noqa: E731
    return {
        "ln1_scale": stack("layers.{i}.layer_norm1.weight"),
        "ln1_bias": stack("layers.{i}.layer_norm1.bias"),
        "qkv_w": qkv("weight", tr),
        "qkv_b": qkv("bias", lambda b: b),
        "o_w": stack("layers.{i}.self_attn.out_proj.weight", tr),
        "o_b": stack("layers.{i}.self_attn.out_proj.bias"),
        "ln2_scale": stack("layers.{i}.layer_norm2.weight"),
        "ln2_bias": stack("layers.{i}.layer_norm2.bias"),
        "fc_w": stack("layers.{i}.mlp.fc1.weight", tr),
        "fc_b": stack("layers.{i}.mlp.fc1.bias"),
        "proj_w": stack("layers.{i}.mlp.fc2.weight", tr),
        "proj_b": stack("layers.{i}.mlp.fc2.bias"),
    }


def from_hf_state_dict(cfg: CLIPConfig, sd: Dict[str, Any]) -> Params:
    """A HuggingFace ``CLIPModel`` state dict -> the parameter tree
    (``clip.py:676``): the patch convolution ``[D, 3, p, p]`` as the
    ``[3 p p, D]`` matmul weight, Linear weights transposed, q / k / v
    fused; float32 CPU tensors."""
    get = common.hf_getter(sd, ("",), "CLIP")
    t = common.hf_tensor
    conv = get("vision_model.embeddings.patch_embedding.weight")
    return {
        "text": {
            "tok_emb": t(get("text_model.embeddings.token_embedding.weight")),
            "pos_emb": t(get(
                "text_model.embeddings.position_embedding.weight")),
            "blocks": _tower_from_hf(get, "text_model.encoder.",
                                     cfg.text_layers),
            "lnf_scale": t(get("text_model.final_layer_norm.weight")),
            "lnf_bias": t(get("text_model.final_layer_norm.bias")),
        },
        "vision": {
            "patch_w": t(conv.reshape(conv.shape[0], -1).T),
            "class_emb": t(get("vision_model.embeddings.class_embedding")),
            "pos_emb": t(get(
                "vision_model.embeddings.position_embedding.weight")),
            "pre_ln_scale": t(get("vision_model.pre_layrnorm.weight")),
            "pre_ln_bias": t(get("vision_model.pre_layrnorm.bias")),
            "blocks": _tower_from_hf(get, "vision_model.encoder.",
                                     cfg.vision_layers),
            "post_ln_scale": t(get("vision_model.post_layernorm.weight")),
            "post_ln_bias": t(get("vision_model.post_layernorm.bias")),
        },
        "text_projection": t(get("text_projection.weight").T),
        "visual_projection": t(get("visual_projection.weight").T),
        # ascontiguousarray makes a 0-d array 1-d
        "logit_scale": t(get("logit_scale")).reshape(()),
    }


def build(cfg: Optional[CLIPConfig] = None, **overrides
          ) -> common.FunctionalModel:
    """The model (``clip.py:718``): ``flops_per_token = 6 x
    num_params``."""
    import sys

    cfg = cfg or CLIPConfig(**overrides)
    return common.FunctionalModel(
        cfg, sys.modules[__name__],
        f"clip-{cfg.vision_layers}l-{cfg.vision_width}d",
        flops_per_token=6.0 * cfg.num_params())
