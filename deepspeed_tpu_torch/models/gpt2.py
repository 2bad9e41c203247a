"""GPT-2 family — the PyTorch port of ``deepspeed_tpu/models/gpt2.py``,
limited to what generation and paged serving run.

The model stays functional, as in the JAX package: the parameters are a
nested dict of tensors in the JAX layout (layers stacked ``[L, ...]``,
``x @ W`` weights ``[in, out]``), and each function takes ``(cfg, params,
...)``.  The layer stack is a Python loop over layers (the JAX package uses
``lax.scan``).  ``build`` wraps the functions in an ``nn.Module`` carrying
the ``decode_hooks`` the inference and serving engines read.

The JAX ``forward_cached`` returns a new cache; this one writes the cache
tensors in place and returns the same dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_attention import decode_attention, paged_decode_attention
from ..ops.paged_kv import paged_cache_update

Params = Dict[str, Any]

@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.hidden_size * self.mlp_ratio

    @staticmethod
    def gpt2_125m() -> "GPT2Config":
        return GPT2Config(num_layers=12, num_heads=12, hidden_size=768)

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 64) -> "GPT2Config":
        return GPT2Config(vocab_size=vocab_size, max_seq_len=max_seq_len,
                          num_layers=2, num_heads=4, hidden_size=64)


def init_params(cfg: GPT2Config, generator: torch.Generator) -> Params:
    """Random GPT-2 parameters, same shapes and scales as the JAX
    ``init_params`` (``models/gpt2.py:130``), drawn from ``generator`` on
    its device in float32.  The draws differ from JAX's for the same seed;
    to run the same weights in both packages use :func:`params_from_jax`."""
    d, l, f = cfg.hidden_size, cfg.num_layers, cfg.ffn_size
    std = 0.02
    res_std = std / math.sqrt(2 * l)
    dev = generator.device

    def normal(shape, s=std):
        return torch.randn(shape, generator=generator, device=dev) * s

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return {
        "wte": normal((cfg.vocab_size, d)),
        "wpe": normal((cfg.max_seq_len, d), 0.01),
        "blocks": {
            "ln1_scale": ones(l, d),
            "ln1_bias": zeros(l, d),
            "qkv_w": normal((l, d, 3 * d)),
            "qkv_b": zeros(l, 3 * d),
            "o_w": normal((l, d, d), res_std),
            "o_b": zeros(l, d),
            "ln2_scale": ones(l, d),
            "ln2_bias": zeros(l, d),
            "fc_w": normal((l, d, f)),
            "fc_b": zeros(l, f),
            "proj_w": normal((l, f, d), res_std),
            "proj_b": zeros(l, d),
        },
        "lnf_scale": ones(d),
        "lnf_bias": zeros(d),
    }


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX GPT-2 parameter pytree given as
    numpy arrays (``jax.device_get(params)``).  The mapping is the identity
    on names and layouts: ``wte [V, D]``, ``wpe [S, D]``, ``lnf_*``, and
    ``blocks/*`` stacked ``[L, ...]`` with matmul weights ``[in, out]``
    (``qkv_w [L, D, 3D]``, ``o_w [L, D, D]``, ``fc_w [L, D, 4D]``,
    ``proj_w [L, 4D, D]``) — both packages compute ``x @ W``.  Arrays are
    copied into CPU tensors of their own dtype."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    import numpy as np

    return torch.from_numpy(np.array(tree, copy=True))


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    """Layer norm in f32, cast back to the input dtype (``gpt2.py:163``).
    ``F.layer_norm`` reduces each row alone, the same way in any batch, so
    a greedy request decodes to the same bf16 tokens in ``generate``'s
    batch of 4 as in an 8-slot server; mean/var as tensor reductions pick
    their CUDA thread layout from the row count, and did not."""
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps)
    return (y * scale + bias).to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _layer(blocks: Params, i: int) -> Params:
    return {name: w[i] for name, w in blocks.items()}


def _qkv(cfg: GPT2Config, layer, y):
    """q, k, v as contiguous [B, H, T, hd] tensors."""
    b, t, _ = y.shape
    qkv = y @ layer["qkv_w"].to(y.dtype) + layer["qkv_b"].to(y.dtype)
    return [z.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
            .contiguous() for z in qkv.chunk(3, dim=-1)]


def _mlp_residual(layer, x):
    y = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    hid = _gelu(y @ layer["fc_w"].to(y.dtype) + layer["fc_b"].to(y.dtype))
    return x + hid @ layer["proj_w"].to(x.dtype) + layer["proj_b"].to(x.dtype)


def _block(cfg: GPT2Config, x, layer):
    """One transformer block, einsum attention (``gpt2.py:333-342``)."""
    b, s, d = x.shape
    y = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    q, k, v = _qkv(cfg, layer, y)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(cfg.head_dim)
    scores = torch.where(mask, scores.float(), -1e9)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ layer["o_w"].to(x.dtype) + layer["o_b"].to(x.dtype)
    return _mlp_residual(layer, x)


def forward(cfg: GPT2Config, params: Params, input_ids):
    """Token logits [B, S, V] (``gpt2.py:354``). input_ids: [B, S] ints."""
    s = input_ids.shape[1]
    x = (params["wte"][input_ids] + params["wpe"][:s]).to(params["wte"].dtype)
    for i in range(cfg.num_layers):
        x = _block(cfg, x, _layer(params["blocks"], i))
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["wte"].T.to(x.dtype)


def init_cache(cfg: GPT2Config, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Static KV workspace ``[L, B, H, S, hd]`` (``gpt2.py:364``); with
    ``batch_size = num_blocks`` and ``max_len = block_size`` it is the
    paged pool."""
    shape = (cfg.num_layers, batch_size, cfg.num_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_update(ck, cv, k, v, pos):
    """Write new keys/values into a contiguous cache in place
    (``gpt2.py:371``): an int ``pos`` writes one [T]-span shared by every
    row, starting at ``pos`` clamped so the span fits (as
    ``lax.dynamic_update_slice`` clamps); an int32 [B] tensor writes each
    row's single new entry at its own position (T must be 1)."""
    if not isinstance(pos, torch.Tensor) or pos.ndim == 0:
        t, s = k.shape[2], ck.shape[2]
        start = min(max(int(pos), 0), s - t)
        ck[:, :, start:start + t] = k.to(ck.dtype)
        cv[:, :, start:start + t] = v.to(cv.dtype)
        return ck, cv
    if k.shape[2] != 1:
        raise ValueError("per-sequence positions require T == 1")
    rows = torch.arange(k.shape[0], device=k.device)
    p = pos.to(torch.int64)
    ck[rows, :, p] = k[:, :, 0].to(ck.dtype)
    cv[rows, :, p] = v[:, :, 0].to(cv.dtype)
    return ck, cv


def _cached_attention(q, k, v, ck, cv, pos, block_tables=None,
                      chunk_valid=None):
    """Write new KV + attend, on either cache layout (``gpt2.py:391``).
    Contiguous (``block_tables is None``): ck/cv are [B, H, S, hd].  Paged:
    ck/cv are the shared [NB, H, bs, hd] pool reached through
    ``block_tables`` int32 [B, NBPER]; ``chunk_valid`` (int32 [B]) marks
    how many of a T>1 chunk's tokens are real — pads write to scratch."""
    if block_tables is None:
        cache_update(ck, cv, k, v, pos)
        return decode_attention(q, ck, cv, pos)
    paged_cache_update(ck, cv, k, v, pos, block_tables, valid=chunk_valid)
    return paged_decode_attention(q, ck, cv, block_tables, pos)


def _block_cached_body(cfg: GPT2Config, x, layer, ck, cv, pos,
                       block_tables=None, chunk_valid=None):
    """One block with KV-cache read/write (``gpt2.py:413``).  x: [B, T, D];
    ck/cv: one layer's cache or pool slice, written in place; pos: the
    global position of x[:, 0] — int, or int32 [B] per-row positions."""
    b, t, d = x.shape
    y = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    q, k, v = _qkv(cfg, layer, y)
    attn = _cached_attention(q, k, v, ck, cv, pos, block_tables, chunk_valid)
    attn = attn.transpose(1, 2).reshape(b, t, d)
    x = x + attn @ layer["o_w"].to(x.dtype) + layer["o_b"].to(x.dtype)
    return _mlp_residual(layer, x)


def forward_cached(cfg: GPT2Config, params: Params, input_ids, cache, pos,
                   lengths=None, block_tables=None, all_positions=False):
    """Incremental forward (``gpt2.py:503``): logits for the LAST input
    position (or every position with ``all_positions``) and the cache,
    written in place.  Three position modes, as in the JAX function:

     - ``lengths`` given and T == 1 (per-row decode): row ``b``'s token sits
       at position ``lengths[b]``; ``pos`` is ignored.
     - ``block_tables`` given and ``pos`` an int32 [B] tensor (chunked
       prefill): row ``b``'s T-token window starts at ``pos[b]``;
       ``lengths`` counts its real tokens (pads write to scratch) and picks
       the returned logits at ``lengths[b] - 1``.
     - otherwise ``pos`` is one int shared by every row; a ``lengths``
       vector with T > 1 picks each row's logits at ``lengths[b] - 1``.

    ``cache`` is ``{"k", "v"}`` of ``[L, B, H, S, hd]`` (contiguous) or
    ``[L, NB, H, bs, hd]`` (paged, with ``block_tables`` int32 [B, NBPER]).
    """
    b, t = input_ids.shape
    wpe = params["wpe"]
    smax = cfg.max_seq_len
    per_row = lengths is not None and t == 1
    if per_row:
        step_pos = lengths
        pe = wpe[lengths.to(torch.int64).clamp(0, smax - 1)][:, None]
    elif block_tables is not None and isinstance(pos, torch.Tensor) \
            and pos.ndim == 1:
        step_pos = pos
        ar = torch.arange(t, device=pos.device)
        pe = wpe[(pos.to(torch.int64)[:, None] + ar[None, :]).clamp(0, smax - 1)]
    else:
        step_pos = int(pos)
        start = min(max(step_pos, 0), smax - t)
        pe = wpe[start:start + t]
    x = (params["wte"][input_ids] + pe).to(params["wte"].dtype)
    chunk_valid = lengths if (block_tables is not None
                              and lengths is not None and t > 1) else None
    for i in range(cfg.num_layers):
        x = _block_cached_body(cfg, x, _layer(params["blocks"], i),
                               cache["k"][i], cache["v"][i], step_pos,
                               block_tables=block_tables,
                               chunk_valid=chunk_valid)
    if not all_positions:
        x = _gather_last(x, lengths if not per_row else None)
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["wte"].T.to(x.dtype), cache


def _gather_last(x, lengths):
    """Last valid hidden state per row (``gpt2.py:571``): column T-1 when
    ``lengths`` is None, else each row's ``lengths[b] - 1``."""
    if lengths is None:
        return x[:, -1]
    t = x.shape[1]
    idx = (lengths.to(torch.int64) - 1).clamp(0, t - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


class GPT2Model(nn.Module):
    """The ``nn.Module`` face of the functional model: carries the config,
    the random initializer, and the ``decode_hooks`` the engines read
    (``gpt2.py:835-858``).  Parameters live with the engine, as a nested
    dict of tensors, so one model object can back several engines."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.model_config = cfg
        self.name = f"gpt2-{cfg.num_layers}l-{cfg.hidden_size}d"
        self.decode_hooks = {
            "init_cache": lambda b, s, dtype=torch.bfloat16, device=None:
                init_cache(cfg, b, s, dtype, device),
            "forward_cached": lambda params, ids, cache, pos, lengths=None,
                block_tables=None, all_positions=False:
                forward_cached(cfg, params, ids, cache, pos, lengths,
                               block_tables, all_positions),
            # learned absolute positions: the engines reject requests past it
            "max_seq_len": cfg.max_seq_len,
            "supports_lengths": True,
            "supports_paged": True,
        }

    def init_fn(self, generator: torch.Generator) -> Params:
        return init_params(self.model_config, generator)

    def forward(self, params: Params, input_ids):
        return forward(self.model_config, params, input_ids)


def build(cfg: Optional[GPT2Config] = None, **overrides) -> GPT2Model:
    return GPT2Model(cfg or GPT2Config(**overrides))
