"""GPT-J family (6B) — the PyTorch port of ``deepspeed_tpu/models/gptj.py``:
the forward and loss, generation and the HuggingFace state-dict import.

Functional, in the JAX layout, as ``models/gpt2.py``.  What is GPT-J's:

 - **interleaved rotary** on the first ``rotary_dim`` dims: (even, odd)
   pairs rotate, not halves as in GPT-NeoX;
 - one layer norm a block feeding both branches of a parallel residual
   ``x + attn(y) + mlp(y)``;
 - bias-free separate q/k/v/o projections, a tanh-GELU MLP with biases,
   and an untied head with a bias (``lm_head_w [D, V]``, ``lm_head_b``);
   head dim 256 at 6B.

Decoding runs over a contiguous cache with one shared position, as the
JAX family does, through ``gpt2.decode_over_layers`` probing ``q_w`` for
the stacked w8a8 kernel (``gptj.py:217``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import math

import torch
import torch.nn.functional as F

from . import common, gpt2
from .common import DecoderModel, causal_attention, inv_freq, run_layers

Params = Dict[str, Any]


@dataclasses.dataclass
class GPTJConfig:
    vocab_size: int = 50400
    max_seq_len: int = 2048
    num_layers: int = 28
    num_heads: int = 16
    hidden_size: int = 4096
    rotary_dim: int = 64
    rope_theta: float = 10000.0
    mlp_ratio: int = 4
    #: explicit FFN width (HF ``n_inner``); None = mlp_ratio * hidden_size
    ffn_dim: Optional[int] = None
    dropout: float = 0.0
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.ffn_dim or self.hidden_size * self.mlp_ratio

    @staticmethod
    def gptj_6b() -> "GPTJConfig":
        return GPTJConfig()

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 64) -> "GPTJConfig":
        return GPTJConfig(vocab_size=vocab_size, max_seq_len=max_seq_len,
                          num_layers=2, num_heads=4, hidden_size=64,
                          rotary_dim=8)

    @staticmethod
    def from_hf(hf) -> "GPTJConfig":
        """Translate a ``transformers.GPTJConfig`` (``gptj.py:63``)."""
        return GPTJConfig(
            vocab_size=hf.vocab_size,
            max_seq_len=hf.n_positions,
            num_layers=hf.n_layer,
            num_heads=hf.n_head,
            hidden_size=hf.n_embd,
            rotary_dim=hf.rotary_dim or (hf.n_embd // hf.n_head),
            ffn_dim=hf.n_inner or 4 * hf.n_embd)

    def num_params(self) -> int:
        d, l, v, f = self.hidden_size, self.num_layers, self.vocab_size, \
            self.ffn_size
        per_layer = 4 * d * d + (2 * f * d + f + d) + 2 * d
        return v * d + l * per_layer + 2 * d + (v * d + v)


def _layer_shapes(cfg: GPTJConfig):
    d, f = cfg.hidden_size, cfg.ffn_size
    return (("ln1_scale", (d,), None), ("ln1_bias", (d,), 0.0),
            ("q_w", (d, d), 0.02), ("k_w", (d, d), 0.02),
            ("v_w", (d, d), 0.02), ("o_w", (d, d), 0.02),
            ("fc_w", (d, f), 0.02), ("fc_b", (f,), 0.0),
            ("proj_w", (f, d), 0.02), ("proj_b", (d,), 0.0))


def init_params(cfg: GPTJConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                layer_fn: Optional[Callable] = None) -> Params:
    """Random parameters with the JAX ``init_params``' shapes and scales
    (``gptj.py:81``), drawn on the generator's device layer after layer."""
    normal, ones = common.drawers(generator, dtype, device)
    d, v = cfg.hidden_size, cfg.vocab_size
    params = {"wte": normal((v, d))}
    params["blocks"] = gpt2.draw_layers(_layer_shapes(cfg), cfg.num_layers,
                                        normal, ones, layer_fn)
    params["lnf_scale"] = ones((d,))
    params["lnf_bias"] = normal((d,), 0.0)
    params["lm_head_w"] = normal((d, v))
    params["lm_head_b"] = normal((v,), 0.0)
    return params


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX GPT-J pytree of numpy arrays (the
    identity on names and layouts)."""
    return gpt2.params_from_jax(tree)


def _rope_interleaved(cfg: GPTJConfig, x, offset: int = 0):
    """GPT-J rotary (``gptj.py:116``): (even, odd) dim pairs of the first
    ``rotary_dim`` dims rotate, in f32, cast back.  x: [B, H, S, hd]."""
    b, h, s, _ = x.shape
    rot = cfg.rotary_dim
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = inv_freq(rot, cfg.rope_theta, x.device)
    pos = torch.arange(s, dtype=torch.float32, device=x.device) + offset
    ang = pos[:, None] * inv[None, :]                       # [s, rot/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    even, odd = x_rot[..., 0::2].float(), x_rot[..., 1::2].float()
    x_rot = torch.stack([even * cos - odd * sin, odd * cos + even * sin],
                        dim=-1).reshape(b, h, s, rot)
    return torch.cat([x_rot.to(x.dtype), x_pass], dim=-1)


def _heads(cfg: GPTJConfig, z):
    b, t, _ = z.shape
    return z.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)


def _block_body(cfg: GPTJConfig, x, get, mm, pos: int = 0, cache=None):
    """One GPT-J block (``gptj.py:143``), over a contiguous cache written
    in place at ``pos`` when given."""
    b, s, d = x.shape
    y = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    q = _rope_interleaved(cfg, _heads(cfg, mm(y, "q_w", None)), pos)
    k = _rope_interleaved(cfg, _heads(cfg, mm(y, "k_w", None)), pos)
    v = _heads(cfg, mm(y, "v_w", None)).contiguous()
    if cache is not None:
        ck, cv = cache
        gpt2.cache_update(ck, cv, k, v, pos)
        k, v = ck, cv
    attn = causal_attention(q, k, v, math.sqrt(cfg.head_dim), pos)
    attn_out = mm(attn.transpose(1, 2).reshape(b, s, d), "o_w", x.dtype)
    # the parallel residual reads the same norm output
    hid = F.gelu(mm(y, "fc_w", None) + get("fc_b").to(y.dtype),
                 approximate="tanh")
    mlp_out = mm(hid, "proj_w", x.dtype) + get("proj_b").to(x.dtype)
    return x + attn_out + mlp_out


def _block(cfg: GPTJConfig, x, layer: Params):
    return _block_body(cfg, x, *gpt2.layer_accessors(layer))


def _embed(params: Params, input_ids):
    return params["wte"][input_ids].to(params["wte"].dtype)


def _head(params: Params, x):
    x = gpt2._layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["lm_head_w"].to(x.dtype) + \
        params["lm_head_b"].to(x.dtype)


def forward(cfg: GPTJConfig, params: Params, input_ids):
    """Token logits [B, S, V] (``gptj.py:185``)."""
    params = gpt2._dequant_resident(params)
    x = run_layers(cfg, params, _embed(params, input_ids), _block)
    return _head(params, x)


def init_cache(cfg: GPTJConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Static KV workspace ``[L, B, H, S, hd]`` (``gptj.py:202``)."""
    return common.init_cache(cfg, batch_size, max_len, dtype, device)


def forward_cached(cfg: GPTJConfig, params: Params, input_ids, cache, pos):
    """Incremental forward (``gptj.py:208``): the last position's logits
    and the cache, written in place at the shared int ``pos``; the layer
    loop probes ``q_w`` for the stacked w8a8 kernel."""
    params = gpt2._dequant_resident(params)
    pos = int(pos)
    x = gpt2.decode_over_layers(
        lambda x, get, mm, ck, cv: _block_body(cfg, x, get, mm, pos,
                                               (ck, cv)),
        _embed(params, input_ids), params["blocks"], cache["k"], cache["v"],
        cfg.num_layers, probe="q_w")
    return _head(params, x[:, -1]), cache


def loss_from_batch(cfg: GPTJConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Next-token cross entropy (``gptj.py:227``)."""
    del rng, train
    input_ids, labels = common.split_batch(batch)
    return common.ce_from_logits(forward(cfg, params, input_ids), labels)


# --------------------------------------------------------------------- HF I/O
def from_hf_state_dict(cfg: GPTJConfig, sd: Dict[str, Any]) -> Params:
    """The parameter tree from a HuggingFace GPT-J state dict
    (``gptj.py:266``): Linear weights ``[out, in]`` transposed."""
    get = common.hf_getter(sd, ("transformer.", ""), "GPT-J")
    stack = common.hf_stacker(get, cfg.num_layers)
    t = lambda w: w.T  # noqa: E731
    return {
        "wte": common.hf_tensor(get("wte.weight")),
        "blocks": {
            "ln1_scale": stack("h.{i}.ln_1.weight"),
            "ln1_bias": stack("h.{i}.ln_1.bias"),
            "q_w": stack("h.{i}.attn.q_proj.weight", t),
            "k_w": stack("h.{i}.attn.k_proj.weight", t),
            "v_w": stack("h.{i}.attn.v_proj.weight", t),
            "o_w": stack("h.{i}.attn.out_proj.weight", t),
            "fc_w": stack("h.{i}.mlp.fc_in.weight", t),
            "fc_b": stack("h.{i}.mlp.fc_in.bias"),
            "proj_w": stack("h.{i}.mlp.fc_out.weight", t),
            "proj_b": stack("h.{i}.mlp.fc_out.bias"),
        },
        "lnf_scale": common.hf_tensor(get("ln_f.weight")),
        "lnf_bias": common.hf_tensor(get("ln_f.bias")),
        "lm_head_w": common.hf_tensor(get("lm_head.weight").T),
        "lm_head_b": common.hf_tensor(get("lm_head.bias")),
    }


def build(cfg: Optional[GPTJConfig] = None, **overrides) -> DecoderModel:
    import sys

    return DecoderModel(cfg or GPTJConfig(**overrides),
                        sys.modules[__name__], "gptj")
