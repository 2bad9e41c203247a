"""BLOOM family (560m, 7b1) — the PyTorch port of
``deepspeed_tpu/models/bloom.py``: the forward and loss, generation, paged
serving and the HuggingFace state-dict import.

The structure is GPT-2's (``models/gpt2.py``): functional, parameters a
nested dict of tensors in the JAX layout (layers stacked ``[L, ...]``,
``x @ W`` weights ``[in, out]``, q/k/v fused into ``qkv_w`` as ``[q; k;
v]`` column blocks), a Python loop over layers and an ``nn.Module``
carrying the ``decode_hooks``.  What is BLOOM's:

 - **ALiBi**: no position table; each head adds ``slope_h * (k_pos -
   q_pos)`` (f32) to its scores, the slopes of :func:`alibi_slopes`;
 - a layer norm on the word embeddings, an exact-erf GELU MLP, biases
   everywhere and a head tied to ``word_embeddings``;
 - HF's fused qkv interleaved by head (``[h, 3, hd]`` rows), regrouped
   into ``[q; k; v]`` by :func:`from_hf_state_dict`.

The additive bias rules out the shared attention kernels, so attention is
einsum plus the f32 bias, as in JAX: on a paged pool the cached path reads
each row's logical view through ``ops/paged_kv.paged_gather`` (int8 pool
records dequantize there) and biases it by each row's absolute positions —
a decode step's ``lengths``, a prefill chunk's per-row bases, a verify
window's bases.  Its matmuls, the tied head's included, run on the fixed
row counts of ``utils/rows.py``, as llama's and OPT's do, so a served
row's bf16 bits do not depend on the rows beside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import common, gpt2
from ..ops.paged_kv import paged_cache_update, paged_gather
from ..utils.rows import fixed_row_mm

Params = Dict[str, Any]


@dataclasses.dataclass
class BloomConfig:
    vocab_size: int = 250880
    num_layers: int = 24
    num_heads: int = 16
    hidden_size: int = 1024
    max_seq_len: int = 2048
    dropout: float = 0.0
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @staticmethod
    def bloom_560m() -> "BloomConfig":
        return BloomConfig(num_layers=24, num_heads=16, hidden_size=1024)

    @staticmethod
    def bloom_7b1() -> "BloomConfig":
        return BloomConfig(num_layers=30, num_heads=32, hidden_size=4096)

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 64) -> "BloomConfig":
        return BloomConfig(vocab_size=vocab_size, max_seq_len=max_seq_len,
                           num_layers=2, num_heads=4, hidden_size=64)

    @staticmethod
    def from_hf(hf) -> "BloomConfig":
        """Translate a ``transformers.BloomConfig`` (``bloom.py:58``)."""
        return BloomConfig(vocab_size=hf.vocab_size,
                           num_layers=hf.n_layer, num_heads=hf.n_head,
                           hidden_size=hf.hidden_size,
                           max_seq_len=getattr(hf, "seq_length", 2048))

    def num_params(self) -> int:
        d, l, v = self.hidden_size, self.num_layers, self.vocab_size
        per_layer = (3 * d * d + 3 * d) + (d * d + d) + \
            (4 * d * d + 4 * d) + (4 * d * d + d) + 4 * d
        return v * d + 2 * d + l * per_layer + 2 * d


def alibi_slopes(num_heads: int) -> np.ndarray:
    """The published ALiBi slope schedule (``bloom.py:73``): powers of
    ``2^(-8/n)`` for a power-of-two head count; otherwise those of the
    closest lower power of two, then every other slope of the doubled
    schedule.  float32."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        return np.asarray(pow2_slopes(num_heads), np.float32)
    closest = 2 ** math.floor(math.log2(num_heads))
    base = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return np.asarray(base + extra, np.float32)


#: (num_heads, device) -> the slopes on that device, made at a shape's
#: first (eager) call so a captured decode step never copies from the host
_SLOPES: Dict[tuple, torch.Tensor] = {}


def _slopes(num_heads: int, device) -> torch.Tensor:
    key = (num_heads, str(device))
    if key not in _SLOPES:
        _SLOPES[key] = torch.from_numpy(alibi_slopes(num_heads)).to(device)
    return _SLOPES[key]


def _layer_shapes(cfg: BloomConfig):
    """(name, shape of one layer, std / None for ones / 0.0 for zeros) in
    the JAX tree's order (``bloom.py:87``)."""
    d = cfg.hidden_size
    return (("ln1_scale", (d,), None), ("ln1_bias", (d,), 0.0),
            ("qkv_w", (d, 3 * d), 0.02), ("qkv_b", (3 * d,), 0.0),
            ("o_w", (d, d), 0.02), ("o_b", (d,), 0.0),
            ("ln2_scale", (d,), None), ("ln2_bias", (d,), 0.0),
            ("fc_w", (d, 4 * d), 0.02), ("fc_b", (4 * d,), 0.0),
            ("proj_w", (4 * d, d), 0.02), ("proj_b", (d,), 0.0))


def init_params(cfg: BloomConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                layer_fn: Optional[Callable] = None) -> Params:
    """Random BLOOM parameters with the shapes and scales of the JAX
    ``init_params`` (``bloom.py:87``: std 0.02, zero biases, unit LN
    scales), drawn from ``generator`` on its device, the word embeddings
    first, then layer after layer (``gpt2.draw_layers``; ``layer_fn``
    quantizes each layer as it is drawn).  The draws differ from JAX's;
    to run the same weights in both packages use :func:`params_from_jax`."""
    normal, ones = common.drawers(generator, dtype, device)
    d = cfg.hidden_size
    params = {"word_embeddings": normal((cfg.vocab_size, d)),
              "word_ln_scale": ones((d,)), "word_ln_bias": normal((d,), 0.0)}
    params["blocks"] = gpt2.draw_layers(_layer_shapes(cfg), cfg.num_layers,
                                        normal, ones, layer_fn)
    params["lnf_scale"] = ones((d,))
    params["lnf_bias"] = normal((d,), 0.0)
    return params


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX BLOOM parameter pytree given as
    numpy arrays: the identity on names and layouts, as
    :func:`gpt2.params_from_jax` copies them."""
    return gpt2.params_from_jax(tree)


def _softmax_attend(cfg: BloomConfig, q, kk, vv, qpos, kpos):
    """ALiBi attention of ``q [B, H, T, hd]`` over ``kk``/``vv [B, H, S,
    hd]``: scores in q's dtype scaled by ``1/sqrt(hd)``, then in f32 plus
    ``slope_h * (kpos - qpos)``, causal by position (``qpos`` ``[B | 1,
    T]``, ``kpos`` ``[S]``), softmax in f32, probabilities cast back
    (``bloom.py:247-257``)."""
    scores = torch.einsum("bhtd,bhsd->bhts", q, kk) / math.sqrt(cfg.head_dim)
    rel = (kpos[None, None, :] - qpos[:, :, None]).float()  # [B|1, T, S]
    slopes = _slopes(cfg.num_heads, q.device)
    scores = scores.float() + slopes[None, :, None, None] * rel[:, None]
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, vv)


def _attention(cfg: BloomConfig, q, k, v):
    """Causal + ALiBi attention over one window (``bloom.py:134``)."""
    s = q.shape[2]
    ar = torch.arange(s, device=q.device)
    return _softmax_attend(cfg, q, k, v, ar[None], ar)


def _mlp(get, mm, x):
    y = gpt2._layer_norm(x, get("ln2_scale"), get("ln2_bias"))
    hid = F.gelu(mm(y, "fc_w", None) + get("fc_b").to(y.dtype))
    return x + mm(hid, "proj_w", x.dtype) + get("proj_b").to(x.dtype)


def _block(cfg: BloomConfig, x, layer: Params):
    """One BLOOM block (``bloom.py:148``)."""
    b, s, d = x.shape
    get, mm = gpt2.layer_accessors(layer)
    y = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    q, k, v = common.split_heads(cfg, mm(y, "qkv_w", None)
                           + get("qkv_b").to(y.dtype))
    attn = _attention(cfg, q, k, v).transpose(1, 2).reshape(b, s, d)
    x = x + mm(attn, "o_w", x.dtype) + get("o_b").to(x.dtype)
    return _mlp(get, mm, x)


def _embed(cfg: BloomConfig, params: Params, input_ids):
    """Word embeddings through their layer norm (``bloom.py:181``)."""
    del cfg
    x = params["word_embeddings"][input_ids]
    return gpt2._layer_norm(x, params["word_ln_scale"],
                            params["word_ln_bias"])


def _head(params: Params, x):
    x = gpt2._layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["word_embeddings"].T.to(x.dtype)


def forward(cfg: BloomConfig, params: Params, input_ids):
    """Token logits [B, S, V] (``bloom.py:186``).  input_ids: [B, S]."""
    params = gpt2._dequant_resident(params)
    x = _embed(cfg, params, input_ids)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        layer = gpt2._layer(params["blocks"], i)
        if remat:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(_block, cfg, x, layer, use_reentrant=False)
        else:
            x = _block(cfg, x, layer)
    return _head(params, x)


def init_cache(cfg: BloomConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Static KV workspace ``[L, B, H, S, hd]`` (``bloom.py:203``); with
    ``batch_size = num_blocks`` and ``max_len = block_size`` it is the
    paged pool."""
    return common.init_cache(cfg, batch_size, max_len, dtype, device)


def _alibi_cached_attention(cfg: BloomConfig, q, k, v, ck, cv, pos,
                            block_tables=None, chunk_valid=None):
    """Write the new keys/values and attend (``bloom.py:210``) on either
    cache layout: contiguous (``gpt2.cache_update``) or paged
    (``paged_cache_update``, then each row's logical view through
    ``paged_gather``, int8 records dequantized to q's dtype).  ``pos`` is
    an int, or int32 ``[B]`` per-row positions (decode) or window bases
    (chunked prefill, verify); the bias and the causal mask read the
    absolute positions ``pos + arange(T)``.  Resident windows are not
    ported (``init_serving`` refuses ``resident_window_blocks``)."""
    if block_tables is None:
        gpt2.cache_update(ck, cv, k, v, pos)
        kk, vv = ck, cv
    else:
        paged_cache_update(ck, cv, k, v, pos, block_tables,
                           valid=chunk_valid)
        kk = paged_gather(ck, block_tables, out_dtype=q.dtype)
        vv = paged_gather(cv, block_tables, out_dtype=q.dtype)
    t, s, dev = q.shape[2], kk.shape[2], q.device
    ar = torch.arange(t, device=dev)
    if isinstance(pos, torch.Tensor):
        qpos = pos.to(dev).reshape(-1, 1).to(torch.int64) + ar[None]
    else:
        qpos = (ar + int(pos))[None]
    return _softmax_attend(cfg, q, kk, vv, qpos, torch.arange(s, device=dev))


def _block_cached_body(cfg: BloomConfig, x, get, mm, ck, cv, pos,
                       block_tables=None, chunk_valid=None):
    """One BLOOM block over a KV cache (``bloom.py:261``), weights through
    ``get(name)`` / ``mm(y, name, dtype)`` (``gpt2.decode_over_layers``)."""
    b, t, d = x.shape
    y = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    q, k, v = common.split_heads(cfg, mm(y, "qkv_w", None)
                           + get("qkv_b").to(y.dtype))
    attn = _alibi_cached_attention(cfg, q, k, v, ck, cv, pos, block_tables,
                                   chunk_valid)
    attn = attn.transpose(1, 2).reshape(b, t, d)
    x = x + mm(attn, "o_w", x.dtype) + get("o_b").to(x.dtype)
    return _mlp(get, mm, x)


def forward_cached(cfg: BloomConfig, params: Params, input_ids, cache, pos,
                   lengths=None, block_tables=None, all_positions=False):
    """Incremental forward (``bloom.py:286``): logits for the last input
    position (every position with ``all_positions``, the speculative
    verify head, each matmul then one window position at a time, as
    ``gpt2.forward_cached`` runs it) and the cache, written in place.  The
    position modes are GPT-2's: ``lengths`` with T == 1 gives each row's
    decode position; a paged call with an int32 [B] ``pos`` gives each
    row's window base (``lengths`` then counts its real tokens); otherwise
    ``pos`` is one int.  ALiBi has no position table: only the attention
    bias moves with the positions.  Matmuls and the head run on
    ``utils.rows``' fixed row counts."""
    params = gpt2._dequant_resident(params)
    t = input_ids.shape[1]
    per_row = lengths is not None and t == 1
    if per_row:
        step_pos = lengths
    elif isinstance(pos, torch.Tensor) and pos.ndim == 1:
        step_pos = pos
    else:
        step_pos = int(pos)
    chunk_valid = lengths if (block_tables is not None
                              and lengths is not None and t > 1) else None
    x = _embed(cfg, params, input_ids)
    stepwise = all_positions and t > 1
    x = gpt2.decode_over_layers(
        lambda x, get, mm, ck, cv: _block_cached_body(
            cfg, x, get, mm, ck, cv, step_pos, block_tables=block_tables,
            chunk_valid=chunk_valid),
        x, params["blocks"], cache["k"], cache["v"], cfg.num_layers,
        stepwise=stepwise, rows="decode" if t == 1 or stepwise else "prefill")
    if not all_positions:
        x = gpt2._gather_last(x, lengths if not per_row else None)
    head = fixed_row_mm(lambda y, name, dtype: _head(params, y), "decode")
    if stepwise:
        head = gpt2._stepwise(head)
    return head(x, "word_embeddings", x.dtype), cache


def loss_from_batch(cfg: BloomConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Next-token cross entropy (``bloom.py:333``)."""
    del rng, train
    input_ids, labels = common.split_batch(batch)
    return common.ce_from_logits(forward(cfg, params, input_ids), labels)


# --------------------------------------------------------------------- HF I/O
def regroup_qkv(cfg, w=None, b=None):
    """HF's fused qkv interleaved by head (rows ``[h, 3, hd]``, BLOOM and
    GPT-NeoX) as ``[q; k; v]`` blocks: a ``[3D, D]`` weight becomes
    ``[D, 3D]`` (``x @ W``), a ``[3D]`` bias ``[3D]``."""
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    if w is not None:
        w = w.reshape(h, 3, hd, d)
        return np.concatenate([w[:, i].reshape(d, d) for i in range(3)],
                              axis=0).T
    b = b.reshape(h, 3, hd)
    return np.concatenate([b[:, i].reshape(d) for i in range(3)])


def from_hf_state_dict(cfg: BloomConfig, sd: Dict[str, Any]) -> Params:
    """The parameter tree from a HuggingFace BLOOM state dict
    (``bloom.py:367``): numpy arrays or tensors under the HF names (with
    or without ``transformer.``), the head-interleaved qkv regrouped into
    ``[q; k; v]``, ``[out, in]`` Linear weights transposed; float32 CPU
    tensors."""
    get = common.hf_getter(sd, ("transformer.", ""), "BLOOM")
    stack = common.hf_stacker(get, cfg.num_layers)
    one = common.hf_tensor
    t = lambda w: w.T  # noqa: E731
    return {
        "word_embeddings": one(get("word_embeddings.weight")),
        "word_ln_scale": one(get("word_embeddings_layernorm.weight")),
        "word_ln_bias": one(get("word_embeddings_layernorm.bias")),
        "blocks": {
            "ln1_scale": stack("h.{i}.input_layernorm.weight"),
            "ln1_bias": stack("h.{i}.input_layernorm.bias"),
            "qkv_w": stack("h.{i}.self_attention.query_key_value.weight",
                           lambda w: regroup_qkv(cfg, w=w)),
            "qkv_b": stack("h.{i}.self_attention.query_key_value.bias",
                           lambda b: regroup_qkv(cfg, b=b)),
            "o_w": stack("h.{i}.self_attention.dense.weight", t),
            "o_b": stack("h.{i}.self_attention.dense.bias"),
            "ln2_scale": stack("h.{i}.post_attention_layernorm.weight"),
            "ln2_bias": stack("h.{i}.post_attention_layernorm.bias"),
            "fc_w": stack("h.{i}.mlp.dense_h_to_4h.weight", t),
            "fc_b": stack("h.{i}.mlp.dense_h_to_4h.bias"),
            "proj_w": stack("h.{i}.mlp.dense_4h_to_h.weight", t),
            "proj_b": stack("h.{i}.mlp.dense_4h_to_h.bias"),
        },
        "lnf_scale": one(get("ln_f.weight")),
        "lnf_bias": one(get("ln_f.bias")),
    }


class BloomModel(nn.Module):
    """The ``nn.Module`` face of the functional model (``bloom.py:420``):
    the config, the random initializer, ``loss_fn``, ``flops_per_token``
    and the ``decode_hooks`` (paged serving, the verify window, the int8
    pool, sampling) and ``pipeline_hooks`` the engines read."""

    quant_aware = True
    blocks_key = ("blocks",)
    #: the inference engine draws default weights on its device in the
    #: serving dtype, quantizing each layer as it is drawn (``layer_fn``)
    init_on_device = True

    def __init__(self, cfg: BloomConfig):
        super().__init__()
        if cfg.dropout:
            raise NotImplementedError(
                "bloom: dropout is not implemented yet (the forward ignores "
                "it); set dropout=0")
        self.model_config = cfg
        self.name = f"bloom-{cfg.num_layers}l-{cfg.hidden_size}d"
        self.flops_per_token = 6.0 * cfg.num_params()
        self.decode_hooks = {
            "init_cache": lambda b, s, dtype=torch.bfloat16, device=None:
                init_cache(cfg, b, s, dtype, device),
            "forward_cached": lambda params, ids, cache, pos, lengths=None,
                block_tables=None, all_positions=False:
                forward_cached(cfg, params, ids, cache, pos, lengths,
                               block_tables, all_positions),
            # no learned position table: the context is bounded only by the
            # KV workspace
            "max_seq_len": None,
            "supports_lengths": True,
            "supports_paged": True,
            "supports_verify": True,
            # the pool is read only through paged_gather, which dequantizes
            # int8 records
            "supports_kv_quant": True,
            "supports_sampling": True,
        }
        self.pipeline_hooks = {
            "blocks_key": ("blocks",),
            "embed_fn": lambda params, ids: _embed(cfg, params, ids),
            "block_fn": lambda layer, x, rng=None: _block(cfg, x, layer),
            "head_loss_fn": lambda params, x, tgt: common.ce_from_logits(
                _head(params, x), tgt),
            "dropout": 0.0,
        }

    def init_fn(self, generator: torch.Generator, dtype=torch.float32,
                layer_fn: Optional[Callable] = None) -> Params:
        return init_params(self.model_config, generator, dtype,
                           layer_fn=layer_fn)

    def loss_fn(self, params: Params, batch, rng=None, train: bool = True):
        return loss_from_batch(self.model_config, params, batch, rng, train)

    def forward(self, params: Params, input_ids):
        return forward(self.model_config, params, input_ids)


def build(cfg: Optional[BloomConfig] = None, **overrides) -> BloomModel:
    return BloomModel(cfg or BloomConfig(**overrides))
