"""Llama family (Llama-2/3) — the PyTorch port of
``deepspeed_tpu/models/llama.py``: generation, paged serving and the
training loss.

The structure is GPT-2's (``models/gpt2.py``): functional, parameters a
nested dict of tensors in the JAX layout (layers stacked ``[L, ...]``,
``x @ W`` weights ``[in, out]``), a Python loop over layers, and an
``nn.Module`` (:class:`LlamaModel`) carrying the ``decode_hooks`` the
inference and serving engines read.  What is Llama's: RMSNorm, rotary
position embeddings (HF half-split), grouped-query attention (``num_heads``
query heads over ``num_kv_heads`` KV heads: the cache holds KV heads only),
a SwiGLU MLP, no biases and an untied LM head.

Decoding shares GPT-2's machinery: :func:`forward_cached` runs its layers
through ``gpt2.decode_over_layers`` (the stacked w8a8 kernel selecting each
layer when the blocks are K-grouped records, probed on ``q_w``) and its
attention through the decode-attention kernels, which take GQA and head
dim 128.  RoPE applies before the cache write, so the pool's int8 records
(``kv8``) pass through this family untouched.  Two choices keep a row's
bf16 arithmetic the same whatever shares its call (the JAX package needs
neither on the TPU): a prefill window's attention runs the verify kernel
sixteen positions at a time (:func:`_cached_attention`), and its matmuls
run on fixed row counts (``utils/rows.py``: 256-row blocks in prefill, at
least 8 rows a decode step).

``forward`` and ``loss_from_batch`` are the training path: attention by
``cfg.use_flash`` as in GPT-2 (``None``: the flash kernels on CUDA, at head
dim 128 with the KV heads unrepeated, einsum elsewhere); ``cfg.remat``
recomputes each block in the backward pass (``torch.utils.checkpoint``),
as ``jax.checkpoint`` does, so a remat micro-step launches the flash
forward twice a layer and dq and dkv once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import gpt2
from ..ops.decode_attention import VERIFY_T_MAX, sliced_window_attention
from ..ops.flash_attention import flash_attention
from ..ops.paged_kv import paged_cache_update
from ..utils.rows import fixed_row_mm

Params = Dict[str, Any]

@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 128256
    max_seq_len: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    hidden_size: int = 4096
    ffn_size: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    remat: bool = True
    #: None = the flash-attention kernel on CUDA, einsum elsewhere; True =
    #: ``ops.flash_attention`` on any device; False = einsum
    use_flash: Optional[bool] = None
    #: ZeRO-3 liveness (layers gathered a scan step): 1 on one GPU
    scan_group_size: int = 1
    #: the sequence-parallel attention of a mesh with sp > 1
    sp_impl: str = "auto"

    def __post_init__(self):
        """Refuse the multi-GPU options this port does not have yet
        (``ROADMAP.md`` Queue A item 8).  ``dataclasses.replace`` runs this
        too."""
        if self.scan_group_size != 1:
            raise NotImplementedError(
                f"LlamaConfig.scan_group_size={self.scan_group_size}: "
                "ZeRO-3 layer gathering comes with the PyTorch port's "
                "multi-GPU slice (ROADMAP.md Queue A item 8)")
        if self.sp_impl != "auto":
            raise NotImplementedError(
                f"LlamaConfig.sp_impl={self.sp_impl!r}: sequence-parallel "
                "attention comes with the PyTorch port's multi-GPU slice "
                "(ROADMAP.md Queue A item 8)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(num_layers=80, num_heads=64, num_kv_heads=8,
                           hidden_size=8192, ffn_size=28672)

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, max_seq_len=max_seq_len,
                           num_layers=2, num_heads=4, num_kv_heads=2,
                           hidden_size=64, ffn_size=128, rope_theta=10000.0,
                           remat=False)

    def num_params(self) -> int:
        d, f, l, v = self.hidden_size, self.ffn_size, self.num_layers, \
            self.vocab_size
        hd = self.head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + \
            self.num_heads * hd * d
        mlp = 3 * d * f
        return v * d + l * (attn + mlp + 2 * d) + d + d * v


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """Random Llama parameters, the shapes and scales of the JAX
    ``init_params`` (``llama.py:80``), drawn from ``generator`` on its
    device in float32 one leaf (stacked leaves: one layer) at a time and
    stored in ``dtype``, so an 8B model drawn on the card in bf16 never
    holds more than one layer's f32 draw beside its 16 GB of weights.
    ``device`` must be the generator's (the default).  The draws differ
    from JAX's for the same seed; to run the same weights in both packages
    use :func:`params_from_jax`."""
    dev = generator.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"init_params draws on the generator's device "
                         f"{dev}, not {device}")
    d, f, l = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    std = 0.02

    def normal(shape, s=std):
        return (torch.randn(shape, generator=generator, device=dev) * s
                ).to(dtype)

    def stacked(shape, s=std):
        out = torch.empty((l,) + shape, dtype=dtype, device=dev)
        for i in range(l):
            out[i] = normal(shape, s)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "embed": normal((cfg.vocab_size, d)),
        "blocks": {
            "attn_norm": ones(l, d),
            "q_w": stacked((d, hq)),
            "k_w": stacked((d, hkv)),
            "v_w": stacked((d, hkv)),
            "o_w": stacked((hq, d), std / math.sqrt(2 * l)),
            "mlp_norm": ones(l, d),
            "w1": stacked((d, f)),
            "w3": stacked((d, f)),
            "w2": stacked((f, d), std / math.sqrt(2 * l)),
        },
        "final_norm": ones(d),
        "lm_head": normal((d, cfg.vocab_size)),
    }


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX Llama parameter pytree given as
    numpy arrays (``jax.device_get(params)``): the identity on names and
    layouts (``embed [V, D]``, ``blocks/*`` stacked ``[L, ...]`` with
    ``q_w [L, D, H*hd]``, ``k_w``/``v_w [L, D, HKV*hd]``, ``o_w [L, H*hd,
    D]``, ``w1``/``w3 [L, D, F]``, ``w2 [L, F, D]``, the norms, ``lm_head
    [D, V]``), as :func:`gpt2.params_from_jax` copies them."""
    return gpt2.params_from_jax(tree)


def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm in f32, cast back to the input dtype (``llama.py:106``):
    ``x * rsqrt(mean(x^2) + eps) * scale``.  The mean of squares is summed
    in float64, whose products of f32 values are exact and whose sum of a
    row's squares rounds back to the same f32 in any summation order but
    for ties of probability ~2^-16: a tensor reduction picks its CUDA
    thread layout from the row count, so an f32 sum would give a row other
    bits in ``generate``'s batch of 4 than in an 8-slot server, and flip
    near-tie bf16 tokens (``F.layer_norm``'s per-row kernel serves GPT-2;
    RMSNorm has no such kernel)."""
    x32 = x.to(torch.float32)
    var = (x32.to(torch.float64).square().sum(-1, keepdim=True)
           / x.shape[-1]).to(torch.float32)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _inv_freq(cfg: LlamaConfig, device):
    hd = cfg.head_dim
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(torch.full_like(exps, cfg.rope_theta), exps)


def rope_angles(cfg: LlamaConfig, seq_len: int, offset: int = 0,
                device=None):
    """``(cos, sin)`` [S, hd/2] f32 of positions ``offset ..`` (``:112``)."""
    inv_freq = _inv_freq(cfg, device)
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    angles = pos[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Rotate pairs of x [B, H, S, hd] (HF half-split: element i pairs with
    i + hd/2) by ``cos``/``sin`` [S, hd/2] (shared by the batch) or
    [B, S, hd/2] (per-row positions); the rotation in f32, cast back to x's
    dtype (``:121``)."""
    hd = x.shape[-1]
    x1, x2 = x[..., :hd // 2].float(), x[..., hd // 2:].float()
    if cos.ndim == 3:
        c, s = cos[:, None], sin[:, None]
    else:
        c, s = cos[None, None], sin[None, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _rope_cached(cfg: LlamaConfig, x, pos):
    """RoPE at offset ``pos`` (``:230``): an int or a 0-d tensor shared by
    every row, or an int32 [B] tensor of per-row positions (decode slots,
    chunked-prefill bases).  x: [B, H, T, hd].  Built on x's device from
    shapes and ``pos`` alone: nothing crosses from the host, so a captured
    decode step replays it."""
    inv_freq = _inv_freq(cfg, x.device)
    t = torch.arange(x.shape[2], dtype=torch.float32, device=x.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        p = pos.to(torch.float32)[:, None] + t[None, :]            # [B, T]
        angles = p[..., None] * inv_freq[None, None, :]           # [B, T, hd/2]
    else:
        angles = (t + pos)[:, None] * inv_freq[None, :]           # [T, hd/2]
    return apply_rope(x, torch.cos(angles), torch.sin(angles))


def _attention(cfg: LlamaConfig, q, k, v):
    """Causal attention over [B, H(KV), S, hd] (``:142``): the flash
    kernels or einsum by ``cfg.use_flash`` (module docstring).  The flash
    op takes the KV heads as they are: query head h reads KV head
    h // (H // HKV) in place, as the JAX kernels' index map does."""
    use_flash = cfg.use_flash
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        return flash_attention(q, k, v, causal=True)
    rep = cfg.num_heads // cfg.num_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s_len = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(cfg.head_dim)
    mask = torch.ones((s_len, k.shape[2]), dtype=torch.bool,
                      device=q.device).tril()
    scores = torch.where(mask, scores.float(), -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _swiglu(mm, y, dtype):
    """``w2(silu(w1 y) * w3 y)``."""
    return mm(F.silu(mm(y, "w1", None)) * mm(y, "w3", None), "w2", dtype)


def block_apply(cfg: LlamaConfig, layer: Params, x, cos, sin):
    """One block of the training forward (``:165``); matmuls through
    ``gpt2._qmm`` (int8 records take their kernels)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    get, mm = gpt2.layer_accessors(layer)
    y = rms_norm(x, get("attn_norm"), cfg.rms_eps)
    q = mm(y, "q_w", None).reshape(b, s, h, hd).transpose(1, 2)
    k = mm(y, "k_w", None).reshape(b, s, hkv, hd).transpose(1, 2)
    v = mm(y, "v_w", None).reshape(b, s, hkv, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin).contiguous()
    attn = _attention(cfg, q, k, v.contiguous())
    attn = attn.transpose(1, 2).reshape(b, s, h * hd)
    x = x + mm(attn, "o_w", x.dtype)
    y = rms_norm(x, get("mlp_norm"), cfg.rms_eps)
    return x + _swiglu(mm, y, x.dtype)


def _trunk(cfg: LlamaConfig, params: Params, input_ids):
    """Embedding + all blocks: pre-final-norm activations [B, S, D] in the
    embedding's dtype; with ``cfg.remat`` and autograd on, each block is
    recomputed in the backward pass."""
    s = input_ids.shape[1]
    x = params["embed"][input_ids].to(params["embed"].dtype)
    cos, sin = rope_angles(cfg, s, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        layer = gpt2._layer(params["blocks"], i)
        if remat:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(block_apply, cfg, layer, x, cos, sin,
                           use_reentrant=False)
        else:
            x = block_apply(cfg, layer, x, cos, sin)
    return x


def forward(cfg: LlamaConfig, params: Params, input_ids):
    """Token logits [B, S, V] (``:190``).  input_ids: [B, S] ints."""
    params = gpt2._dequant_resident(params)
    x = _trunk(cfg, params, input_ids)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"].to(x.dtype)


def loss_from_batch(cfg: LlamaConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """Mean next-token cross entropy over the targets that are not -100
    (``:333``); ``batch`` as ``gpt2.loss_from_batch`` takes it.  Llama's
    pretraining config has no dropout, so ``rng`` and ``train`` change
    nothing."""
    del rng, train
    if isinstance(batch, (tuple, list)):
        input_ids, labels = batch
    else:
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
    if labels is None:
        labels = input_ids[:, 1:]
        input_ids = input_ids[:, :-1]
    params = gpt2._dequant_resident(params)
    return _head_loss(cfg, params, _trunk(cfg, params, input_ids), labels)


def _head_loss(cfg: LlamaConfig, params: Params, x, labels):
    """Final RMSNorm, LM head and the mean cross entropy over the labels
    that are not -100 (``llama.py:406``, ``pp_head_loss``)."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def _block_hook(cfg: LlamaConfig, layer: Params, x):
    """One block with its RoPE angles (``llama.py:402``, ``pp_block``)."""
    cos, sin = rope_angles(cfg, x.shape[1], device=x.device)
    return block_apply(cfg, layer, x, cos, sin)


def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Static KV workspace ``[L, B, HKV, S, hd]`` (``:206``: KV heads
    only); with ``batch_size = num_blocks`` and ``max_len = block_size`` it
    is the paged pool."""
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cached_attention(q, k, v, ck, cv, pos, block_tables=None,
                      chunk_valid=None):
    """``gpt2._cached_attention`` (write the new KV, attend), with a window
    wider than ``VERIFY_T_MAX`` written whole and attended by
    ``sliced_window_attention``: the verify kernel sixteen query positions
    at a time, on the paged pool or on the contiguous cache read as a pool.
    So a prompt row gets the same bits in ``generate``'s prefill, a
    128-token server window and a 16-token one (the JAX dispatch gives
    wide windows the plain path, which on random Llama-3-8B weights moved
    near-tie bf16 tokens of a chunk-16 server against a chunk-128 one)."""
    if q.shape[2] <= VERIFY_T_MAX:
        return gpt2._cached_attention(q, k, v, ck, cv, pos, block_tables,
                                      chunk_valid)
    if block_tables is None:
        gpt2.cache_update(ck, cv, k, v, pos)
    else:
        paged_cache_update(ck, cv, k, v, pos, block_tables, valid=chunk_valid)
    return sliced_window_attention(q, ck, cv, pos, block_tables)


def _block_cached_body(cfg: LlamaConfig, x, get, mm, ck, cv, pos,
                       mlp=None, block_tables=None, chunk_valid=None):
    """One block with KV-cache read/write (``:244``), weights through
    ``get(name)`` / ``mm(y, name, dtype)`` (``gpt2.decode_over_layers``).
    ck/cv: one layer's
    cache or pool slice (or int8 record), written in place; ``pos`` as
    :func:`_rope_cached` takes it; paged layout with ``block_tables``
    (``gpt2._cached_attention``).  ``mlp(get, y)`` replaces the dense
    SwiGLU (mixtral's MoE FFN), returning the residual's addend in x's
    dtype."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    y = rms_norm(x, get("attn_norm"), cfg.rms_eps)
    q = mm(y, "q_w", None).reshape(b, t, h, hd).transpose(1, 2)
    k = mm(y, "k_w", None).reshape(b, t, hkv, hd).transpose(1, 2)
    v = mm(y, "v_w", None).reshape(b, t, hkv, hd).transpose(1, 2)
    q = _rope_cached(cfg, q, pos).contiguous()
    k = _rope_cached(cfg, k, pos).contiguous()
    attn = _cached_attention(q, k, v.contiguous(), ck, cv, pos,
                             block_tables, chunk_valid)
    attn = attn.transpose(1, 2).reshape(b, t, h * hd)
    x = x + mm(attn, "o_w", x.dtype)
    y = rms_norm(x, get("mlp_norm"), cfg.rms_eps)
    if mlp is not None:
        return x + mlp(get, y)
    return x + _swiglu(mm, y, x.dtype)


def forward_cached(cfg: LlamaConfig, params: Params, input_ids, cache, pos,
                   lengths=None, block_tables=None, mlp_fn=None,
                   all_positions=False):
    """Incremental forward (``:288``): logits for the last input position
    (every position with ``all_positions``, the speculative verify head,
    each matmul then one window position at a time as in
    ``gpt2.forward_cached``) and the cache, written in place.  The matmuls
    and the head run on fixed row counts (``utils.rows.fixed_rows``: a
    prefill window in 256-row blocks, a decode step or a verify position
    on at least 8 rows), so a row's bits do not depend on how many rows
    share its call.  The
    position modes are GPT-2's: ``lengths`` with T == 1 decodes row ``b`` at
    ``lengths[b]`` (RoPE offset, cache write, attention prefix); with
    ``block_tables`` and an int32 [B] ``pos`` each row's window starts at
    ``pos[b]`` (chunked prefill) and ``lengths`` counts its real tokens;
    otherwise ``pos`` is one int shared by every row.  ``cache`` is ``{"k", "v"}`` of ``[L, B, HKV, S, hd]`` or
    the paged ``[L, NB, HKV, bs, hd]`` pool, each leaf possibly an int8
    record.  ``mlp_fn(get, y)`` replaces each block's SwiGLU (mixtral
    delegates here with its MoE FFN, which gates a whole window, a
    stepwise verify's included, as one group); the layers still run
    through ``gpt2.decode_over_layers``, so w8a8 attention projections
    keep the indexed stacked-kernel route."""
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
    x = params["embed"][input_ids].to(params["embed"].dtype)
    stepwise = all_positions and t > 1
    blocks = params["blocks"]
    # a stepwise verify multiplies one position at a time, a decode step's
    # rows
    x = gpt2.decode_over_layers(
        lambda x, get, mm, ck, cv: _block_cached_body(
            cfg, x, get, mm, ck, cv, step_pos, mlp=mlp_fn,
            block_tables=block_tables, chunk_valid=chunk_valid),
        x, blocks, cache["k"], cache["v"], cfg.num_layers,
        probe="q_w", stepwise=stepwise,
        rows="decode" if t == 1 or stepwise else "prefill")
    if not all_positions:
        x = gpt2._gather_last(x, lengths if not per_row else None)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = fixed_row_mm(
        lambda y, name, dtype: y @ params["lm_head"].to(dtype), "decode")
    if stepwise:
        head = gpt2._stepwise(head)
    return head(x, "lm_head", x.dtype), cache


class LlamaModel(nn.Module):
    """The ``nn.Module`` face of the functional model (``:365``): the
    config, the random initializer, the training ``loss_fn`` and
    ``flops_per_token``, and the ``decode_hooks`` the engines read.
    Parameters live with the engine, as a nested dict of tensors.  Rotary
    positions set no context length, so the hooks name none (the server's
    default ``max_seq_len`` is 512, as in the JAX package)."""

    #: the engines may store ``blocks`` as int8 records
    quant_aware = True
    #: where the stacked per-layer weights live in the parameter tree
    blocks_key = ("blocks",)
    #: the inference engine draws default weights with a generator on its
    #: device, in the serving dtype (``init_fn`` takes ``dtype``)
    init_on_device = True

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.model_config = cfg
        self.name = f"llama-{cfg.num_layers}l-{cfg.hidden_size}d"
        self.flops_per_token = 6.0 * cfg.num_params()
        self.decode_hooks = {
            "init_cache": lambda b, s, dtype=torch.bfloat16, device=None:
                init_cache(cfg, b, s, dtype, device),
            "forward_cached": lambda params, ids, cache, pos, lengths=None,
                block_tables=None, all_positions=False:
                forward_cached(cfg, params, ids, cache, pos, lengths,
                               block_tables, all_positions=all_positions),
            "supports_lengths": True,
            "supports_paged": True,
            "supports_verify": True,
            # RoPE applies before the cache write, so int8 pool records
            # pass through ops/paged_kv untouched by this family
            "supports_kv_quant": True,
            "supports_sampling": True,
        }
        # the block-structured view the parameter-streaming engine drives
        # (``llama.py:419-423``)
        self.pipeline_hooks = {
            "blocks_key": ("blocks",),
            "embed_fn": lambda params, ids: params["embed"][ids].to(
                params["embed"].dtype),
            "block_fn": lambda layer, x, rng=None: _block_hook(cfg, layer, x),
            "head_loss_fn": lambda params, x, tgt: _head_loss(cfg, params, x,
                                                              tgt),
        }

    def init_fn(self, generator: torch.Generator,
                dtype=torch.float32) -> Params:
        return init_params(self.model_config, generator, dtype)

    def loss_fn(self, params: Params, batch, rng=None, train: bool = True):
        return loss_from_batch(self.model_config, params, batch, rng, train)

    def forward(self, params: Params, input_ids):
        return forward(self.model_config, params, input_ids)


def build(cfg: Optional[LlamaConfig] = None, **overrides) -> LlamaModel:
    return LlamaModel(cfg or LlamaConfig(**overrides))
