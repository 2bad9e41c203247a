"""GPT-Neo family (1.3B, 2.7B) — the PyTorch port of
``deepspeed_tpu/models/gptneo.py``: the forward and loss, generation and
the HuggingFace state-dict import.

Functional, in the JAX layout, as ``models/gpt2.py``.  What is GPT-Neo's:

 - learned positions as GPT-2's (``wpe``), separate bias-free q/k/v and
   an out projection with a bias, a tanh-GELU MLP, the head tied to
   ``wte``;
 - **unscaled** attention scores (no ``1/sqrt(hd)``), masked and
   softmaxed in f32;
 - global and **local** layers by ``attention_layers``: a local layer's
   query at position p sees the keys at ``p - window_size < k <= p``.

The layers run in a Python loop whose matmuls go through ``gpt2._qmm`` on
each layer's slice, as the JAX family unrolls them: a K-grouped record
of a decode step (at most 8 rows) runs the w8a8 kernel of one layer
(B5), a prefill window dequantize + matmul.  Decoding runs over a
contiguous cache with one shared position (``generate``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from . import common, gpt2
from .common import DecoderModel, causal_attention

Params = Dict[str, Any]


@dataclasses.dataclass
class GPTNeoConfig:
    vocab_size: int = 50257
    max_seq_len: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    hidden_size: int = 2048
    window_size: int = 256
    #: per-layer attention kind, "global" | "local"; defaults to alternating
    attention_layers: Optional[List[str]] = None
    mlp_ratio: int = 4
    #: explicit FFN width (HF ``intermediate_size``); None = 4 * hidden
    ffn_dim: Optional[int] = None
    dropout: float = 0.0
    remat: bool = False

    def __post_init__(self):
        """Alternating kinds by default; a longer list is cut to the first
        ``num_layers`` kinds (a config cut in depth, e.g.
        ``dataclasses.replace(neo_2p7b(), num_layers=2)``, keeps its first
        layers' kinds; the JAX config asserts the lengths equal)."""
        if self.attention_layers is None:
            self.attention_layers = [
                "global" if i % 2 == 0 else "local"
                for i in range(self.num_layers)]
        self.attention_layers = list(self.attention_layers[:self.num_layers])
        if len(self.attention_layers) != self.num_layers:
            raise ValueError(f"attention_layers names "
                             f"{len(self.attention_layers)} layers, "
                             f"num_layers is {self.num_layers}")

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.ffn_dim or self.hidden_size * self.mlp_ratio

    @staticmethod
    def neo_1p3b() -> "GPTNeoConfig":
        return GPTNeoConfig()

    @staticmethod
    def neo_2p7b() -> "GPTNeoConfig":
        return GPTNeoConfig(num_layers=32, num_heads=20, hidden_size=2560)

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 64) -> "GPTNeoConfig":
        return GPTNeoConfig(vocab_size=vocab_size, max_seq_len=max_seq_len,
                            num_layers=2, num_heads=4, hidden_size=64,
                            window_size=8)

    @staticmethod
    def from_hf(hf) -> "GPTNeoConfig":
        """Translate a ``transformers.GPTNeoConfig`` (``gptneo.py:79``):
        ``attention_layers`` is HF's per-layer expansion of
        ``attention_types``."""
        return GPTNeoConfig(
            vocab_size=hf.vocab_size,
            max_seq_len=hf.max_position_embeddings,
            num_layers=hf.num_layers,
            num_heads=hf.num_heads,
            hidden_size=hf.hidden_size,
            window_size=hf.window_size,
            attention_layers=list(hf.attention_layers),
            ffn_dim=hf.intermediate_size or 4 * hf.hidden_size)

    def num_params(self) -> int:
        d, l, v, f = self.hidden_size, self.num_layers, self.vocab_size, \
            self.ffn_size
        per_layer = 3 * d * d + (d * d + d) + \
            (2 * f * d + f + d) + 4 * d
        return v * d + self.max_seq_len * d + l * per_layer + 2 * d


def _layer_shapes(cfg: GPTNeoConfig):
    d, f = cfg.hidden_size, cfg.ffn_size
    return (("ln1_scale", (d,), None), ("ln1_bias", (d,), 0.0),
            ("q_w", (d, d), 0.02), ("k_w", (d, d), 0.02),
            ("v_w", (d, d), 0.02), ("o_w", (d, d), 0.02), ("o_b", (d,), 0.0),
            ("ln2_scale", (d,), None), ("ln2_bias", (d,), 0.0),
            ("fc_w", (d, f), 0.02), ("fc_b", (f,), 0.0),
            ("proj_w", (f, d), 0.02), ("proj_b", (d,), 0.0))


def init_params(cfg: GPTNeoConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                layer_fn: Optional[Callable] = None) -> Params:
    """Random parameters with the JAX ``init_params``' shapes and scales
    (``gptneo.py:97``: std 0.02, ``wpe`` 0.01), drawn on the generator's
    device layer after layer."""
    normal, ones = common.drawers(generator, dtype, device)
    d = cfg.hidden_size
    params = {"wte": normal((cfg.vocab_size, d)),
              "wpe": normal((cfg.max_seq_len, d), 0.01)}
    params["blocks"] = gpt2.draw_layers(_layer_shapes(cfg), cfg.num_layers,
                                        normal, ones, layer_fn)
    params["lnf_scale"] = ones((d,))
    params["lnf_bias"] = normal((d,), 0.0)
    return params


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX GPT-Neo pytree of numpy arrays (the
    identity on names and layouts)."""
    return gpt2.params_from_jax(tree)


def _heads(cfg: GPTNeoConfig, z):
    b, t, _ = z.shape
    return z.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)


def _block(cfg: GPTNeoConfig, x, layer: Params, local: bool, pos: int = 0,
           cache=None):
    """One GPT-Neo block (``gptneo.py:148``): matmuls through
    ``gpt2._qmm`` on the layer's slice; over a contiguous cache written
    in place at ``pos`` when given."""
    b, s, d = x.shape
    qmm = gpt2._qmm
    y = gpt2._layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    q = _heads(cfg, qmm(y, layer["q_w"]))
    k = _heads(cfg, qmm(y, layer["k_w"]))
    v = _heads(cfg, qmm(y, layer["v_w"]))
    if cache is not None:
        ck, cv = cache
        gpt2.cache_update(ck, cv, k, v, pos)
        k, v = ck, cv
    attn = causal_attention(q, k, v, None, pos,
                            cfg.window_size if local else None)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + qmm(attn, layer["o_w"], x.dtype) + layer["o_b"].to(x.dtype)
    y = gpt2._layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    hid = F.gelu(qmm(y, layer["fc_w"]) + layer["fc_b"].to(y.dtype),
                 approximate="tanh")
    return x + qmm(hid, layer["proj_w"], x.dtype) + \
        layer["proj_b"].to(x.dtype)


def _run_blocks(cfg: GPTNeoConfig, params: Params, x, pos: int = 0,
                cache=None):
    """The layers in a Python loop (``gptneo.py:180``), each with its
    global or local band; each layer's cache written in place."""
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, kind in enumerate(cfg.attention_layers):
        layer = gpt2._layer(params["blocks"], i)
        c = None if cache is None else (gpt2._index(cache["k"], i),
                                        gpt2._index(cache["v"], i))
        if remat:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(_block, cfg, x, layer, kind == "local",
                           use_reentrant=False)
        else:
            x = _block(cfg, x, layer, kind == "local", pos, c)
    return x


def _head(params: Params, x):
    x = gpt2._layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["wte"].T.to(x.dtype)


def forward(cfg: GPTNeoConfig, params: Params, input_ids):
    """Token logits [B, S, V] (``gptneo.py:200``)."""
    params = gpt2._dequant_resident(params)
    s = input_ids.shape[1]
    x = (params["wte"][input_ids] + params["wpe"][:s]).to(
        params["wte"].dtype)
    return _head(params, _run_blocks(cfg, params, x))


def init_cache(cfg: GPTNeoConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Static KV workspace ``[L, B, H, S, hd]`` (``gptneo.py:213``)."""
    return common.init_cache(cfg, batch_size, max_len, dtype, device)


def forward_cached(cfg: GPTNeoConfig, params: Params, input_ids, cache,
                   pos):
    """Incremental forward (``gptneo.py:219``): the last position's logits
    and the cache, written in place at the shared int ``pos``; the learned
    positions start at ``pos`` clamped so the window fits the table (as
    ``lax.dynamic_slice`` clamps)."""
    params = gpt2._dequant_resident(params)
    pos, t = int(pos), input_ids.shape[1]
    wpe = params["wpe"]
    start = min(max(pos, 0), wpe.shape[0] - t)
    x = (params["wte"][input_ids] + wpe[start:start + t]).to(
        params["wte"].dtype)
    x = _run_blocks(cfg, params, x, pos, cache)
    return _head(params, x[:, -1]), cache


def loss_from_batch(cfg: GPTNeoConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Next-token cross entropy (``gptneo.py:233``)."""
    del rng, train
    input_ids, labels = common.split_batch(batch)
    return common.ce_from_logits(forward(cfg, params, input_ids), labels)


# --------------------------------------------------------------------- HF I/O
def from_hf_state_dict(cfg: GPTNeoConfig, sd: Dict[str, Any]) -> Params:
    """The parameter tree from a HuggingFace GPT-Neo state dict
    (``gptneo.py:272``): Linear weights ``[out, in]`` transposed."""
    get = common.hf_getter(sd, ("transformer.", ""), "GPT-Neo")
    stack = common.hf_stacker(get, cfg.num_layers)
    t = lambda w: w.T  # noqa: E731
    return {
        "wte": common.hf_tensor(get("wte.weight")),
        "wpe": common.hf_tensor(get("wpe.weight")),
        "blocks": {
            "ln1_scale": stack("h.{i}.ln_1.weight"),
            "ln1_bias": stack("h.{i}.ln_1.bias"),
            "q_w": stack("h.{i}.attn.attention.q_proj.weight", t),
            "k_w": stack("h.{i}.attn.attention.k_proj.weight", t),
            "v_w": stack("h.{i}.attn.attention.v_proj.weight", t),
            "o_w": stack("h.{i}.attn.attention.out_proj.weight", t),
            "o_b": stack("h.{i}.attn.attention.out_proj.bias"),
            "ln2_scale": stack("h.{i}.ln_2.weight"),
            "ln2_bias": stack("h.{i}.ln_2.bias"),
            "fc_w": stack("h.{i}.mlp.c_fc.weight", t),
            "fc_b": stack("h.{i}.mlp.c_fc.bias"),
            "proj_w": stack("h.{i}.mlp.c_proj.weight", t),
            "proj_b": stack("h.{i}.mlp.c_proj.bias"),
        },
        "lnf_scale": common.hf_tensor(get("ln_f.weight")),
        "lnf_bias": common.hf_tensor(get("ln_f.bias")),
    }


def build(cfg: Optional[GPTNeoConfig] = None, **overrides) -> DecoderModel:
    import sys

    return DecoderModel(cfg or GPTNeoConfig(**overrides),
                        sys.modules[__name__], "gptneo")
