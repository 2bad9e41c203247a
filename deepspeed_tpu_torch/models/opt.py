"""OPT family (125m .. 66B) — the PyTorch port of
``deepspeed_tpu/models/opt.py``: generation, paged serving, the forward
and the HuggingFace state-dict import.

The structure is GPT-2's (``models/gpt2.py``): functional, parameters a
nested dict of tensors in the JAX layout (layers stacked ``[L, ...]``,
``x @ W`` weights ``[in, out]``, q/k/v fused into ``qkv_w``), a Python loop
over layers and an ``nn.Module`` carrying the ``decode_hooks``.  What is
OPT's:

 - learned positions with a fixed offset of 2 (HF
   ``OPTLearnedPositionalEmbedding``), ``embed_positions [max_pos + 2,
   D]``; a window's start clamps as ``lax.dynamic_slice`` clamps it, and
   per-row positions clip to the table;
 - a ReLU MLP, biases everywhere, a head tied to ``embed_tokens``;
 - ``do_layer_norm_before``: pre-LN with a final LN before the head (125m,
   1.3B and up) or post-LN without one (350m);
 - ``word_embed_proj_dim`` != ``hidden_size`` (350m) adds ``project_in`` /
   ``project_out`` around the decoder stack.

Decoding runs through ``gpt2.decode_over_layers`` (the stacked w8a8 kernel
selecting each layer when ``qkv_w`` is a K-grouped record) with llama's
attention (a prefill window wider than the verify kernel's 16 positions is
attended sixteen positions at a time; OPT's heads are all KV heads, GQA
rep 1), and its matmuls, the tied head's included, run on llama's fixed
row counts (``utils/rows.py``): at OPT-13B's shapes on the H100 a row's
bf16 result moved with the rows beside it (``generate`` at batch 1
against the 8-slot server, a 300-token prompt against 128-token windows
of 4 rows).
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
from . import llama
from ..ops.flash_attention import flash_attention
from ..utils.rows import fixed_row_mm

Params = Dict[str, Any]
_POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding.offset


@dataclasses.dataclass
class OPTConfig:
    vocab_size: int = 50272
    max_seq_len: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    ffn_size: int = 3072
    word_embed_proj_dim: Optional[int] = None  # None -> hidden_size
    do_layer_norm_before: bool = True
    dropout: float = 0.0
    remat: bool = False
    #: None = the flash-attention kernel on CUDA, einsum elsewhere
    use_flash: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def has_proj(self) -> bool:
        return self.embed_dim != self.hidden_size

    @staticmethod
    def opt_125m() -> "OPTConfig":
        return OPTConfig(num_layers=12, num_heads=12, hidden_size=768,
                         ffn_size=3072)

    @staticmethod
    def opt_350m() -> "OPTConfig":
        return OPTConfig(num_layers=24, num_heads=16, hidden_size=1024,
                         ffn_size=4096, word_embed_proj_dim=512,
                         do_layer_norm_before=False)

    @staticmethod
    def opt_1_3b() -> "OPTConfig":
        return OPTConfig(num_layers=24, num_heads=32, hidden_size=2048,
                         ffn_size=8192)

    @staticmethod
    def opt_2_7b() -> "OPTConfig":
        return OPTConfig(num_layers=32, num_heads=32, hidden_size=2560,
                         ffn_size=10240)

    @staticmethod
    def opt_6_7b() -> "OPTConfig":
        return OPTConfig(num_layers=32, num_heads=32, hidden_size=4096,
                         ffn_size=16384)

    @staticmethod
    def opt_13b() -> "OPTConfig":
        return OPTConfig(num_layers=40, num_heads=40, hidden_size=5120,
                         ffn_size=20480)

    @staticmethod
    def opt_30b() -> "OPTConfig":
        return OPTConfig(num_layers=48, num_heads=56, hidden_size=7168,
                         ffn_size=28672)

    @staticmethod
    def opt_66b() -> "OPTConfig":
        return OPTConfig(num_layers=64, num_heads=72, hidden_size=9216,
                         ffn_size=36864)

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 64) -> "OPTConfig":
        return OPTConfig(vocab_size=vocab_size, max_seq_len=max_seq_len,
                         num_layers=2, num_heads=4, hidden_size=64,
                         ffn_size=256)

    @staticmethod
    def from_hf(hf_config) -> "OPTConfig":
        """Translate a ``transformers.OPTConfig`` (``opt.py:115``)."""
        return OPTConfig(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.max_position_embeddings,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            hidden_size=hf_config.hidden_size,
            ffn_size=hf_config.ffn_dim,
            word_embed_proj_dim=(
                None if hf_config.word_embed_proj_dim == hf_config.hidden_size
                else hf_config.word_embed_proj_dim),
            do_layer_norm_before=hf_config.do_layer_norm_before,
            dropout=getattr(hf_config, "dropout", 0.0),
        )

    def num_params(self) -> int:
        d, l, f = self.hidden_size, self.num_layers, self.ffn_size
        e = self.embed_dim
        per_layer = (3 * d * d + 3 * d) + (d * d + d) + \
            (d * f + f) + (f * d + d) + 4 * d
        n = self.vocab_size * e + (self.max_seq_len + _POS_OFFSET) * d + \
            l * per_layer
        if self.do_layer_norm_before:
            n += 2 * d
        if self.has_proj:
            n += 2 * e * d
        return n


def _layer_shapes(cfg: OPTConfig):
    """(name, shape of one layer, std / None for ones / 0.0 for zeros) in
    the JAX tree's order (``opt.py:145``)."""
    d, f = cfg.hidden_size, cfg.ffn_size
    return (("ln1_scale", (d,), None), ("ln1_bias", (d,), 0.0),
            ("qkv_w", (d, 3 * d), 0.02), ("qkv_b", (3 * d,), 0.0),
            ("o_w", (d, d), 0.02), ("o_b", (d,), 0.0),
            ("ln2_scale", (d,), None), ("ln2_bias", (d,), 0.0),
            ("fc_w", (d, f), 0.02), ("fc_b", (f,), 0.0),
            ("proj_w", (f, d), 0.02), ("proj_b", (d,), 0.0))


def init_params(cfg: OPTConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                layer_fn: Optional[Callable] = None) -> Params:
    """Random OPT parameters with the shapes and scales of the JAX
    ``init_params`` (``opt.py:145``: std 0.02, zero biases, unit LN
    scales), drawn from ``generator`` on its device in float32 and stored
    in ``dtype``: the embeddings (and projections) first, then layer after
    layer (``gpt2.draw_layers``; ``layer_fn`` quantizes each layer as it
    is drawn, or moves it to the host for ZeRO-Inference).  The draws differ from JAX's; to run the same
    weights in both packages use :func:`params_from_jax`."""
    normal, ones = common.drawers(generator, dtype, device)
    d, e = cfg.hidden_size, cfg.embed_dim
    params = {"embed_tokens": normal((cfg.vocab_size, e)),
              "embed_positions": normal((cfg.max_seq_len + _POS_OFFSET, d))}
    if cfg.has_proj:
        params["project_in"] = normal((e, d))
        params["project_out"] = normal((d, e))
    params["blocks"] = gpt2.draw_layers(_layer_shapes(cfg), cfg.num_layers,
                                        normal, ones, layer_fn)
    if cfg.do_layer_norm_before:
        params["lnf_scale"] = ones((d,))
        params["lnf_bias"] = normal((d,), 0.0)
    return params


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX OPT parameter pytree given as numpy
    arrays: the identity on names and layouts (``embed_tokens [V, E]``,
    ``embed_positions [max_pos + 2, D]``, ``blocks/*`` stacked ``[L, ...]``
    with ``qkv_w [L, D, 3D]``, ``o_w [L, D, D]``, ``fc_w [L, D, F]``,
    ``proj_w [L, F, D]``, their biases and the LN scales and biases,
    ``lnf_*`` and ``project_in``/``project_out`` where the config has
    them), as :func:`gpt2.params_from_jax` copies them."""
    return gpt2.params_from_jax(tree)


def _attention(cfg: OPTConfig, q, k, v):
    """Causal attention on [B, H, S, hd] (``opt.py:183``): the flash
    kernels by ``cfg.use_flash`` (None: on CUDA), einsum elsewhere."""
    use_flash = cfg.use_flash
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        return flash_attention(q, k, v, causal=True)
    s = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(cfg.head_dim)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores.float(), -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _split_heads(cfg: OPTConfig, qkv):
    """q, k, v ``[B, H, T, hd]`` (contiguous) of the fused projection."""
    b, t, _ = qkv.shape
    return [z.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
            .contiguous() for z in qkv.chunk(3, dim=-1)]


def _block(cfg: OPTConfig, x, layer: Params):
    """One decoder layer (``opt.py:199``), pre-LN or post-LN."""
    b, s, d = x.shape
    get, mm = gpt2.layer_accessors(layer)
    res = x
    y = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias")) \
        if cfg.do_layer_norm_before else x
    q, k, v = _split_heads(cfg, mm(y, "qkv_w", None)
                           + get("qkv_b").to(y.dtype))
    attn = _attention(cfg, q, k, v).transpose(1, 2).reshape(b, s, d)
    x = res + mm(attn, "o_w", x.dtype) + get("o_b").to(x.dtype)
    if not cfg.do_layer_norm_before:
        x = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    return _mlp(cfg, get, mm, x)


def _mlp(cfg: OPTConfig, get, mm, x):
    """The ReLU MLP with its residual and (post-LN) norm."""
    res = x
    y = gpt2._layer_norm(x, get("ln2_scale"), get("ln2_bias")) \
        if cfg.do_layer_norm_before else x
    hid = F.relu(mm(y, "fc_w", None) + get("fc_b").to(y.dtype))
    x = res + mm(hid, "proj_w", x.dtype) + get("proj_b").to(x.dtype)
    if not cfg.do_layer_norm_before:
        x = gpt2._layer_norm(x, get("ln2_scale"), get("ln2_bias"))
    return x


def _embed(cfg: OPTConfig, params: Params, input_ids, pos0=0):
    """Token + learned position embeddings (``opt.py:235``).  ``pos0``: an
    int shared by every row (the window starts at ``pos0 + 2`` clamped so
    it fits the table, as ``dynamic_slice`` clamps), or an int32 [B]
    tensor of per-row bases (each position clipped to the table)."""
    s = input_ids.shape[1]
    x = params["embed_tokens"][input_ids]
    if cfg.has_proj:
        x = x @ params["project_in"].to(x.dtype)
    table = params["embed_positions"]
    n = table.shape[0]
    if not isinstance(pos0, torch.Tensor) or pos0.ndim == 0:
        start = min(max(int(pos0) + _POS_OFFSET, 0), n - s)
        pos = table[start:start + s]
    else:
        ar = torch.arange(s, device=pos0.device)
        idx = (pos0.to(torch.int64)[:, None] + ar[None, :]
               + _POS_OFFSET).clamp(0, n - 1)
        pos = table[idx]                                  # [B, S, D]
    return (x + pos).to(params["embed_tokens"].dtype)


def _head(cfg: OPTConfig, params: Params, x):
    """Final LN (pre-LN models) + the tied head (``opt.py:261``)."""
    if cfg.do_layer_norm_before:
        x = gpt2._layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    if cfg.has_proj:
        x = x @ params["project_out"].to(x.dtype)
    return x @ params["embed_tokens"].T.to(x.dtype)


def forward(cfg: OPTConfig, params: Params, input_ids):
    """Token logits [B, S, V] (``opt.py:270``).  input_ids: [B, S] ints."""
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
    return _head(cfg, params, x)


def init_cache(cfg: OPTConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Static KV workspace ``[L, B, H, S, hd]`` (``opt.py:288``); with
    ``batch_size = num_blocks`` and ``max_len = block_size`` it is the
    paged pool."""
    shape = (cfg.num_layers, batch_size, cfg.num_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _block_cached_body(cfg: OPTConfig, x, get, mm, ck, cv, pos,
                       block_tables=None, chunk_valid=None):
    """One decoder layer over a KV cache (``opt.py:294``), weights through
    ``get(name)`` / ``mm(y, name, dtype)`` (``gpt2.decode_over_layers``);
    the attention is ``llama._cached_attention`` (module docstring)."""
    b, t, d = x.shape
    res = x
    y = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias")) \
        if cfg.do_layer_norm_before else x
    q, k, v = _split_heads(cfg, mm(y, "qkv_w", None)
                           + get("qkv_b").to(y.dtype))
    attn = llama._cached_attention(q, k, v, ck, cv, pos, block_tables,
                                   chunk_valid)
    attn = attn.transpose(1, 2).reshape(b, t, d)
    x = res + mm(attn, "o_w", x.dtype) + get("o_b").to(x.dtype)
    if not cfg.do_layer_norm_before:
        x = gpt2._layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    return _mlp(cfg, get, mm, x)


def forward_cached(cfg: OPTConfig, params: Params, input_ids, cache, pos,
                   lengths=None, block_tables=None, all_positions=False):
    """Incremental forward (``opt.py:338``): logits for the last input
    position (every position with ``all_positions``, the speculative
    verify head, each matmul then one window position at a time) and the
    cache, written in place; the matmuls and the head on fixed row counts
    (``utils.rows.fixed_rows``).  The position modes are GPT-2's
    (``gpt2.forward_cached``); the learned positions follow ``lengths``
    (per-row decode), the per-row chunk bases, or the shared int ``pos``."""
    params = gpt2._dequant_resident(params)
    t = input_ids.shape[1]
    per_row = lengths is not None and t == 1
    if per_row:
        step_pos = lengths
    elif block_tables is not None and isinstance(pos, torch.Tensor) \
            and pos.ndim == 1:
        step_pos = pos
    else:
        step_pos = int(pos)
    chunk_valid = lengths if (block_tables is not None
                              and lengths is not None and t > 1) else None
    x = _embed(cfg, params, input_ids, pos0=step_pos)
    stepwise = all_positions and t > 1
    # a stepwise verify's per-position calls take the slots' rows, as the
    # decode step's do
    x = gpt2.decode_over_layers(
        lambda x, get, mm, ck, cv: _block_cached_body(
            cfg, x, get, mm, ck, cv, step_pos,
            block_tables=block_tables, chunk_valid=chunk_valid),
        x, params["blocks"], cache["k"], cache["v"], cfg.num_layers,
        stepwise=stepwise, rows="decode" if t == 1 or stepwise else "prefill")
    if not all_positions:
        x = gpt2._gather_last(x, lengths if not per_row else None)
    head = fixed_row_mm(lambda y, name, dtype: _head(cfg, params, y),
                        "decode")
    if stepwise:
        head = gpt2._stepwise(head)
    return head(x, "embed_tokens", x.dtype), cache


def _stream_block(cfg: OPTConfig, layer: Params, x, ck, cv, pos):
    """One streamed layer (``stream_hooks["block"]``, ``opt.py:553``):
    ``_block_cached_body`` over a pre-sliced layer and its own cache
    (written in place), with the resident cached path's row rule
    (``gpt2.cached_layer_accessors``: 256-row prefill blocks, a decode
    step padded to >= 8 rows), so a streamed token's bits are the
    resident ones."""
    rows = "decode" if x.shape[1] == 1 else "prefill"
    get, mm = gpt2.cached_layer_accessors(layer, x.dtype, rows)
    return _block_cached_body(cfg, x, get, mm, ck, cv, int(pos))


def _stream_head(cfg: OPTConfig, params: Params, x_last):
    """``stream_hooks["head"]``: the last positions' logits ``[B, V]``,
    on the decode row count as :func:`forward_cached`'s head."""
    params = gpt2._dequant_resident(params)
    head = fixed_row_mm(lambda y, name, dtype: _head(cfg, params, y),
                        "decode")
    return head(x_last, "embed_tokens", x_last.dtype)


def loss_from_batch(cfg: OPTConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Next-token cross entropy (``opt.py:390``); ``batch`` as
    ``gpt2.loss_from_batch`` takes it.  Dropout is not ported."""
    del rng, train
    input_ids, labels = common.split_batch(batch)
    return common.ce_from_logits(forward(cfg, params, input_ids), labels)


# --------------------------------------------------------------------- HF I/O
def from_hf_state_dict(cfg: OPTConfig, sd: Dict[str, Any]) -> Params:
    """The parameter tree from a HuggingFace OPT state dict
    (``opt.py:439``): numpy arrays or tensors under the HF names (with or
    without the ``model.decoder.`` / ``decoder.`` prefix), q/k/v fused
    into ``qkv_w``/``qkv_b``, HF's ``[out, in]`` Linear weights transposed
    to ``[in, out]``; float32 CPU tensors."""
    get = common.hf_getter(sd, ("model.decoder.", "decoder.", ""), "OPT")

    def stack(fmt, transpose=False, fuse_qkv=False):
        rows = []
        for i in range(cfg.num_layers):
            if fuse_qkv:
                w = np.concatenate([get(fmt.format(i=i, p=p)) for p in
                                    ("q_proj", "k_proj", "v_proj")], axis=0)
            else:
                w = get(fmt.format(i=i))
            rows.append(w.T if transpose else w)
        return common.hf_tensor(np.stack(rows))

    def one(name, transpose=False):
        w = get(name)
        return common.hf_tensor(w.T if transpose else w)

    params = {
        "embed_tokens": one("embed_tokens.weight"),
        "embed_positions": one("embed_positions.weight"),
        "blocks": {
            "ln1_scale": stack("layers.{i}.self_attn_layer_norm.weight"),
            "ln1_bias": stack("layers.{i}.self_attn_layer_norm.bias"),
            "qkv_w": stack("layers.{i}.self_attn.{p}.weight", transpose=True,
                           fuse_qkv=True),
            "qkv_b": stack("layers.{i}.self_attn.{p}.bias", fuse_qkv=True),
            "o_w": stack("layers.{i}.self_attn.out_proj.weight",
                         transpose=True),
            "o_b": stack("layers.{i}.self_attn.out_proj.bias"),
            "ln2_scale": stack("layers.{i}.final_layer_norm.weight"),
            "ln2_bias": stack("layers.{i}.final_layer_norm.bias"),
            "fc_w": stack("layers.{i}.fc1.weight", transpose=True),
            "fc_b": stack("layers.{i}.fc1.bias"),
            "proj_w": stack("layers.{i}.fc2.weight", transpose=True),
            "proj_b": stack("layers.{i}.fc2.bias"),
        },
    }
    if cfg.do_layer_norm_before:
        params["lnf_scale"] = one("final_layer_norm.weight")
        params["lnf_bias"] = one("final_layer_norm.bias")
    if cfg.has_proj:
        params["project_in"] = one("project_in.weight", transpose=True)
        params["project_out"] = one("project_out.weight", transpose=True)
    return params


class OPTModel(nn.Module):
    """The ``nn.Module`` face of the functional model (``opt.py:501``):
    the config, the random initializer, ``loss_fn`` and
    ``flops_per_token``, and the hooks the engines read: ``decode_hooks``
    (generation and serving), ``stream_hooks`` (``embed``, ``block``,
    ``head``: ZeRO-Inference's per-layer streamed ``generate``,
    ``inference/zero_inference.py``) and ``pipeline_hooks`` (where the
    stacked blocks live, and the per-block training pieces)."""

    quant_aware = True
    blocks_key = ("blocks",)
    #: the inference engine draws default weights on its device in the
    #: serving dtype, quantizing each layer as it is drawn (``layer_fn``)
    init_on_device = True

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.model_config = cfg
        self.name = f"opt-{cfg.num_layers}l-{cfg.hidden_size}d"
        self.flops_per_token = 6.0 * cfg.num_params()
        self.decode_hooks = {
            "init_cache": lambda b, s, dtype=torch.bfloat16, device=None:
                init_cache(cfg, b, s, dtype, device),
            "forward_cached": lambda params, ids, cache, pos, lengths=None,
                block_tables=None, all_positions=False:
                forward_cached(cfg, params, ids, cache, pos, lengths,
                               block_tables, all_positions),
            "max_seq_len": cfg.max_seq_len,
            "supports_lengths": True,
            "supports_paged": True,
            "supports_verify": True,
            # int8 KV pool records flow through ops/paged_kv untouched
            "supports_kv_quant": True,
            "supports_sampling": True,
        }
        self.pipeline_hooks = {
            "blocks_key": ("blocks",),
            "embed_fn": lambda params, ids: _embed(cfg, params, ids),
            "block_fn": lambda layer, x, rng=None: _block(cfg, x, layer),
            "head_loss_fn": lambda params, x, tgt: common.ce_from_logits(
                _head(cfg, params, x), tgt),
            "dropout": cfg.dropout,
        }
        self.stream_hooks = {
            "embed": lambda params, ids, pos: _embed(
                cfg, gpt2._dequant_resident(params), ids, pos0=pos),
            "block": lambda layer, x, ck, cv, pos: _stream_block(
                cfg, layer, x, ck, cv, pos),
            "head": lambda params, x_last: _stream_head(cfg, params, x_last),
        }

    def init_fn(self, generator: torch.Generator, dtype=torch.float32,
                layer_fn: Optional[Callable] = None) -> Params:
        return init_params(self.model_config, generator, dtype,
                           layer_fn=layer_fn)

    def loss_fn(self, params: Params, batch, rng=None, train: bool = True):
        return loss_from_batch(self.model_config, params, batch, rng, train)

    def forward(self, params: Params, input_ids):
        return forward(self.model_config, params, input_ids)


def build(cfg: Optional[OPTConfig] = None, **overrides) -> OPTModel:
    return OPTModel(cfg or OPTConfig(**overrides))
