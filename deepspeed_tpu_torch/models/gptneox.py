"""GPT-NeoX family (Pythia-160m, GPT-NeoX-20B) — the PyTorch port of
``deepspeed_tpu/models/gptneox.py``: the forward and loss, generation and
the HuggingFace state-dict import.

Functional, in the JAX layout, as ``models/gpt2.py``.  What is NeoX's:

 - **partial rotary**: the first ``rotary_ndims`` of each head rotate by
   halves (rotate_half on that slice); at 20B, 24 of head dim 96;
 - **parallel residual** ``x + attn(ln1(x)) + mlp(ln2(x))``, or the
   sequential ``x + attn``, then ``+ mlp(ln2(.))`` when
   ``use_parallel_residual`` is off;
 - an exact-erf GELU MLP, biases everywhere, an untied head ``embed_out
   [D, V]``; HF's fused qkv interleaved by head, regrouped by
   :func:`from_hf_state_dict`.

Decoding runs over a contiguous cache with one shared position, as the
JAX family does (``decode_hooks`` without paged serving): einsum attention
over the whole workspace, masked by position, through
``gpt2.decode_over_layers`` (the stacked w8a8 kernel selects each layer
when ``qkv_w`` is a K-grouped record).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from . import bloom, common, gpt2

Params = Dict[str, Any]


@dataclasses.dataclass
class GPTNeoXConfig:
    vocab_size: int = 50432
    max_seq_len: int = 2048
    num_layers: int = 44
    num_heads: int = 64
    hidden_size: int = 6144
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    use_parallel_residual: bool = True
    dropout: float = 0.0
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def rotary_ndims(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @staticmethod
    def neox_20b() -> "GPTNeoXConfig":
        return GPTNeoXConfig()

    @staticmethod
    def pythia_160m() -> "GPTNeoXConfig":
        return GPTNeoXConfig(num_layers=12, num_heads=12, hidden_size=768,
                             rotary_pct=0.25, vocab_size=50304)

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 64) -> "GPTNeoXConfig":
        return GPTNeoXConfig(vocab_size=vocab_size, max_seq_len=max_seq_len,
                             num_layers=2, num_heads=4, hidden_size=64,
                             rotary_pct=0.5)

    @staticmethod
    def from_hf(hf) -> "GPTNeoXConfig":
        """Translate a ``transformers.GPTNeoXConfig`` (``gptneox.py:66``)."""
        return GPTNeoXConfig(
            vocab_size=hf.vocab_size,
            max_seq_len=hf.max_position_embeddings,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            hidden_size=hf.hidden_size,
            rotary_pct=hf.rotary_pct,
            rope_theta=getattr(hf, "rotary_emb_base", 10000.0),
            use_parallel_residual=hf.use_parallel_residual)

    def num_params(self) -> int:
        d, l, v = self.hidden_size, self.num_layers, self.vocab_size
        per_layer = (3 * d * d + 3 * d) + (d * d + d) + \
            (8 * d * d + 5 * d) + 4 * d
        return 2 * v * d + l * per_layer + 2 * d


def init_params(cfg: GPTNeoXConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                layer_fn: Optional[Callable] = None) -> Params:
    """Random parameters with the JAX ``init_params``' shapes and scales
    (``gptneox.py:84``: std 0.02, zero biases, unit LN scales), drawn on
    the generator's device layer after layer (``gpt2.draw_layers``,
    ``layer_fn`` as in ``bloom.init_params``)."""
    normal, ones = common.drawers(generator, dtype, device)
    d, v = cfg.hidden_size, cfg.vocab_size
    params = {"embed_in": normal((v, d))}
    # a BLOOM layer's leaves, shapes and scales
    params["blocks"] = gpt2.draw_layers(bloom._layer_shapes(cfg),
                                        cfg.num_layers, normal, ones,
                                        layer_fn)
    params["lnf_scale"] = ones((d,))
    params["lnf_bias"] = normal((d,), 0.0)
    params["embed_out"] = normal((d, v))
    return params


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX GPT-NeoX pytree of numpy arrays
    (the identity on names and layouts)."""
    return gpt2.params_from_jax(tree)


def _rope(cfg: GPTNeoXConfig, x, offset: int = 0):
    """Partial rotary (``gptneox.py:118``): rotate_half on the first
    ``rotary_ndims`` of each head, in f32, cast back.  x: [B, H, S, hd]."""
    s, rot = x.shape[2], cfg.rotary_ndims
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = common.inv_freq(rot, cfg.rope_theta, x.device)
    pos = torch.arange(s, dtype=torch.float32, device=x.device) + offset
    ang = pos[:, None] * inv[None, :]                       # [s, rot/2]
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)
    half = rot // 2
    rotated = torch.cat([-x_rot[..., half:], x_rot[..., :half]], dim=-1)
    x_rot = (x_rot.float() * cos + rotated.float() * sin).to(x.dtype)
    return torch.cat([x_rot, x_pass], dim=-1)


def _block_body(cfg: GPTNeoXConfig, x, get, mm, pos: int = 0, cache=None):
    """One NeoX block (``gptneox.py:147``), over a contiguous cache ``(ck,
    cv)`` written in place at ``pos`` when given."""
    b, s, d = x.shape
    y1 = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    q, k, v = common.split_heads(cfg, mm(y1, "qkv_w", None)
                                 + get("qkv_b").to(y1.dtype))
    q = _rope(cfg, q, offset=pos)
    k = _rope(cfg, k, offset=pos)
    if cache is not None:
        ck, cv = cache
        gpt2.cache_update(ck, cv, k, v, pos)
        k, v = ck, cv
    attn = common.causal_attention(q, k, v, math.sqrt(cfg.head_dim), pos)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    attn_out = mm(attn, "o_w", x.dtype) + get("o_b").to(x.dtype)
    if not cfg.use_parallel_residual:
        x = x + attn_out
    y2 = gpt2._layer_norm(x, get("ln2_scale"), get("ln2_bias"))
    hid = F.gelu(mm(y2, "fc_w", None) + get("fc_b").to(y2.dtype))
    mlp_out = mm(hid, "proj_w", x.dtype) + get("proj_b").to(x.dtype)
    if cfg.use_parallel_residual:
        return x + attn_out + mlp_out
    return x + mlp_out


def _block(cfg: GPTNeoXConfig, x, layer: Params):
    return _block_body(cfg, x, *gpt2.layer_accessors(layer))


def _embed(params: Params, input_ids):
    return params["embed_in"][input_ids].to(params["embed_in"].dtype)


def _head(params: Params, x):
    x = gpt2._layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["embed_out"].to(x.dtype)


def forward(cfg: GPTNeoXConfig, params: Params, input_ids):
    """Token logits [B, S, V] (``gptneox.py:194``)."""
    params = gpt2._dequant_resident(params)
    x = common.run_layers(cfg, params, _embed(params, input_ids), _block)
    return _head(params, x)


def init_cache(cfg: GPTNeoXConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Static KV workspace ``[L, B, H, S, hd]`` (``gptneox.py:210``)."""
    return common.init_cache(cfg, batch_size, max_len, dtype, device)


def forward_cached(cfg: GPTNeoXConfig, params: Params, input_ids, cache,
                   pos):
    """Incremental forward (``gptneox.py:216``): the last position's
    logits [B, V] and the cache, written in place at the shared int
    ``pos``."""
    params = gpt2._dequant_resident(params)
    pos = int(pos)
    x = gpt2.decode_over_layers(
        lambda x, get, mm, ck, cv: _block_body(cfg, x, get, mm, pos,
                                               (ck, cv)),
        _embed(params, input_ids), params["blocks"], cache["k"], cache["v"],
        cfg.num_layers)
    return _head(params, x[:, -1]), cache


def loss_from_batch(cfg: GPTNeoXConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Next-token cross entropy (``gptneox.py:235``)."""
    del rng, train
    input_ids, labels = common.split_batch(batch)
    return common.ce_from_logits(forward(cfg, params, input_ids), labels)


# --------------------------------------------------------------------- HF I/O
def from_hf_state_dict(cfg: GPTNeoXConfig, sd: Dict[str, Any]) -> Params:
    """The parameter tree from a HuggingFace GPT-NeoX state dict
    (``gptneox.py:272``): the head-interleaved qkv regrouped, Linear
    weights transposed, ``embed_out`` the untied head ``[D, V]``."""
    get = common.hf_getter(sd, ("gpt_neox.", ""), "GPT-NeoX")
    stack = common.hf_stacker(get, cfg.num_layers)
    t = lambda w: w.T  # noqa: E731
    return {
        "embed_in": common.hf_tensor(get("embed_in.weight")),
        "blocks": {
            "ln1_scale": stack("layers.{i}.input_layernorm.weight"),
            "ln1_bias": stack("layers.{i}.input_layernorm.bias"),
            "qkv_w": stack("layers.{i}.attention.query_key_value.weight",
                           lambda w: bloom.regroup_qkv(cfg, w=w)),
            "qkv_b": stack("layers.{i}.attention.query_key_value.bias",
                           lambda b: bloom.regroup_qkv(cfg, b=b)),
            "o_w": stack("layers.{i}.attention.dense.weight", t),
            "o_b": stack("layers.{i}.attention.dense.bias"),
            "ln2_scale": stack("layers.{i}.post_attention_layernorm.weight"),
            "ln2_bias": stack("layers.{i}.post_attention_layernorm.bias"),
            "fc_w": stack("layers.{i}.mlp.dense_h_to_4h.weight", t),
            "fc_b": stack("layers.{i}.mlp.dense_h_to_4h.bias"),
            "proj_w": stack("layers.{i}.mlp.dense_4h_to_h.weight", t),
            "proj_b": stack("layers.{i}.mlp.dense_4h_to_h.bias"),
        },
        "lnf_scale": common.hf_tensor(get("final_layer_norm.weight")),
        "lnf_bias": common.hf_tensor(get("final_layer_norm.bias")),
        "embed_out": common.hf_tensor(get("embed_out.weight").T),
    }


def build(cfg: Optional[GPTNeoXConfig] = None,
          **overrides) -> common.DecoderModel:
    import sys

    return common.DecoderModel(cfg or GPTNeoXConfig(**overrides),
                        sys.modules[__name__], "gptneox")
