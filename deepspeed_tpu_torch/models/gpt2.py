"""GPT-2 family — the PyTorch port of ``deepspeed_tpu/models/gpt2.py``:
generation, paged serving and the training loss.

The model stays functional, as in the JAX package: the parameters are a
nested dict of tensors in the JAX layout (layers stacked ``[L, ...]``,
``x @ W`` weights ``[in, out]``), and each function takes ``(cfg, params,
...)``.  The layer stack is a Python loop over layers (the JAX package uses
``lax.scan``).  ``build`` wraps the functions in an ``nn.Module`` carrying
the ``decode_hooks`` the inference and serving engines read and the
``loss_fn`` / ``init_fn`` / ``flops_per_token`` the training engine reads.

Attention in ``_block`` follows the JAX dispatch (``gpt2.py:311-342``):
``use_flash=None`` takes the flash-attention kernel when the activations
are on CUDA and einsum attention otherwise; ``use_flash=True`` takes
``ops.flash_attention`` everywhere (its plain version on the CPU);
``use_flash=False`` takes einsum; attention dropout (``dropout > 0`` in
training) takes einsum whatever ``use_flash`` says, as in JAX, with the
keep mask ``uniform(key, probs.shape) < 1 - p`` drawn from the port's
threefry (``ops/sampling.py``), JAX's ``bernoulli`` bit for bit, each
layer's key ``fold_in(rng, layer)``.  ``remat`` recomputes each block in
the backward under ``remat_policy`` (``runtime/remat.py``: full, dots,
dots_flash; ``remat_offload`` keeps the saved outputs in page-locked host
memory), and ``fused_ce`` takes the chunked head that computes its
gradients in the forward (:class:`_FusedCE`).

The JAX ``forward_cached`` returns a new cache; this one writes the cache
tensors in place and returns the same dict.

Quantized serving (``quant_aware``): the engine may store the stacked
``blocks`` matmul weights as int8 records (``ops/quantization.py``).  Every
block matmul goes through :func:`_qmm` — K-grouped (w8a8) records to the
w8a8 kernel, weight-only records to ``quantized_matmul``, dense leaves to
the plain ``x @ w`` they always took — and ``forward_cached`` runs its
layer loop through :func:`_qmm_indexed` (the stacked w8a8 kernel, the
layer index a device scalar) when :func:`use_indexed_decode` holds.  Cache
leaves may be int8 pool records (``ops/paged_kv.py``); they are indexed
leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quantization as quant
from ..ops.decode_attention import decode_attention, paged_decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.paged_kv import paged_cache_update
from ..ops.sampling import fold_in, uniform
from ..runtime.remat import check_policy, checkpoint_block
from ..utils.rows import fixed_row_mm

Params = Dict[str, Any]

@dataclasses.dataclass
class GPT2Config:
    """Every field of the JAX ``GPT2Config`` (``gpt2.py:38-102``), in its
    order, so a JAX config carries over."""
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    remat: bool = False
    #: what a remat block saves: "full" (nothing), "dots" (the projection
    #: outputs) or "dots_flash" (and the flash forward's o and lse)
    remat_policy: str = "dots"
    #: keep the saved outputs in page-locked host memory
    #: (``activation_checkpointing.cpu_checkpointing``)
    remat_offload: bool = False
    #: the head is always tied to ``wte``, as in JAX
    tie_embeddings: bool = True
    #: None = the flash-attention kernel on CUDA, einsum elsewhere; True =
    #: ``ops.flash_attention`` on any device; False = einsum
    use_flash: Optional[bool] = None
    #: the JAX kernel's block sizes; tiling hints the CUDA kernel ignores
    flash_block_q: int = 1024
    flash_block_k: int = 1024
    #: sequence-parallel attention when the mesh has sp > 1
    sp_impl: str = "auto"
    #: the chunked fused CE head (:class:`_FusedCE`), ``ce_chunks`` row
    #: chunks (stepped down until they divide the rows)
    fused_ce: Optional[bool] = None
    ce_chunks: int = 4
    act_quant_bits: Optional[int] = None
    act_quant_type: str = "symmetric"
    random_ltd_keep: Optional[int] = None
    random_ltd_layer_start: int = 1
    random_ltd_layer_num: Optional[int] = None
    sparse_embedding_grad: bool = False
    #: either value: the port's layer loop computes what JAX's scan and
    #: its unrolled loop both compute
    scan_layers: bool = True
    scan_group_size: int = 1

    def __post_init__(self):
        """Refuse the values this port does not have yet, naming the queue
        item that brings each (``ROADMAP.md``).  ``dataclasses.replace``
        runs this too."""
        check_policy(self.remat_policy)
        for name, default in (("act_quant_bits", None),
                              ("act_quant_type", "symmetric"),
                              ("random_ltd_keep", None),
                              ("random_ltd_layer_start", 1),
                              ("random_ltd_layer_num", None)):
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"GPT2Config.{name}={getattr(self, name)!r}: compression "
                    "and random-LTD are not ported yet (ROADMAP.md Queue A "
                    "10)")
        for name, bad in (("sparse_embedding_grad", self.sparse_embedding_grad),
                          ("scan_group_size", self.scan_group_size > 1),
                          ("sp_impl", self.sp_impl != "auto")):
            if bad:
                raise NotImplementedError(
                    f"GPT2Config.{name}={getattr(self, name)!r}: sparse "
                    "gradients, ZeRO-3 layer groups and sequence parallelism "
                    "come with the multi-GPU slice (ROADMAP.md Queue A 8)")

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

    def num_params(self) -> int:
        d, l, v, s = self.hidden_size, self.num_layers, self.vocab_size, \
            self.max_seq_len
        per_layer = (3 * d * d + 3 * d) + (d * d + d) + \
            2 * self.mlp_ratio * d * d + (self.mlp_ratio + 1) * d + 4 * d
        return v * d + s * d + l * per_layer + 2 * d


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


def stack_layers(layers, num_layers: int) -> Params:
    """One-layer stacks (each leaf ``[1, ...]``, int8 records as dicts of
    them) -> ``[L, ...]`` stacks on the first layer's device, allocated at
    the first layer and filled layer by layer, each layer released before
    the next is made."""
    def alloc(v):
        if isinstance(v, dict):
            return {k: alloc(x) for k, x in v.items()}
        return v.new_empty((num_layers,) + tuple(v.shape[1:]))

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i] = src[0]

    blocks = None
    for i, layer in enumerate(layers):
        if blocks is None:
            blocks = alloc(layer)
        fill(blocks, layer, i)
        del layer
    return blocks


def draw_layers(shapes, num_layers: int, normal: Callable, ones: Callable,
                layer_fn: Optional[Callable] = None) -> Params:
    """Stacked ``[L, ...]`` blocks drawn one layer at a time: each layer's
    leaves (``(name, shape, std or None)`` of ``shapes``, as one-layer
    stacks ``[1, ...]``) pass through ``layer_fn`` when given (int8 records
    come back, or the layer moves to the host) and are copied into stacks
    allocated at the first layer (:func:`stack_layers`); only one layer's
    draw is alive at a time."""
    def drawn():
        for _ in range(num_layers):
            layer = {name: ones((1,) + shape) if std is None
                     else normal((1,) + shape, std)
                     for name, shape, std in shapes}
            if layer_fn is not None:
                layer = layer_fn(layer)
            yield layer
            del layer

    return stack_layers(drawn(), num_layers)


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX GPT-2 parameter pytree given as
    numpy arrays (``jax.device_get(params)``).  The mapping is the identity
    on names and layouts: ``wte [V, D]``, ``wpe [S, D]``, ``lnf_*``, and
    ``blocks/*`` stacked ``[L, ...]`` with matmul weights ``[in, out]``
    (``qkv_w [L, D, 3D]``, ``o_w [L, D, D]``, ``fc_w [L, D, 4D]``,
    ``proj_w [L, 4D, D]``) — both packages compute ``x @ W``.  Arrays are
    copied into CPU tensors of their own dtype, so int8 records keep their
    int8 payloads and f32 scales; bfloat16 arrays (``ml_dtypes``) arrive
    as ``torch.bfloat16``.  Lists (the VAE's and UNet's blocks) stay
    lists."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_jax(v) for v in tree]
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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


def _index(leaf, i):
    """``leaf[i]`` for a tensor, leaf by leaf for a record (a view)."""
    if isinstance(leaf, dict):
        return {k: v[i] for k, v in leaf.items()}
    return leaf[i]


def _layer(blocks: Params, i: int) -> Params:
    return {name: _index(w, i) for name, w in blocks.items()}


def _qmm(x, leaf, dtype=None):
    """``x @ leaf`` where ``leaf`` may be an int8 record (``gpt2.py:192``):
    K-grouped (w8a8) records take ``w8a8_matmul``, weight-only records
    ``quantized_matmul``; a dense leaf takes the plain ``x @ w`` in
    ``dtype`` (default x's)."""
    dtype = dtype or x.dtype
    if quant.is_k_quantized(leaf):
        from ..ops.quantized_matmul import w8a8_matmul

        return w8a8_matmul(x, leaf, out_dtype=dtype)
    if quant.is_quantized(leaf):
        from ..ops.quantized_matmul import quantized_matmul

        return quantized_matmul(x, leaf, out_dtype=dtype)
    return x @ leaf.to(dtype)


def _qmm_indexed(x, leaf, layer_idx, dtype=None):
    """``x @ leaf[layer_idx]`` on a STACKED leaf with the layer chosen by
    a one-element int32 device tensor (``gpt2.py:211``): K-grouped records
    run the stacked w8a8 kernel, which reads the index itself; other leaf
    kinds slice the layer and take :func:`_qmm`'s path."""
    dtype = dtype or x.dtype
    if quant.is_k_quantized(leaf):
        from ..ops.quantized_matmul import w8a8_matmul_stacked

        return w8a8_matmul_stacked(x, leaf, layer_idx, out_dtype=dtype)
    return _qmm(x, _index(leaf, layer_idx.reshape(())), dtype)


def use_indexed_decode(blocks, probe: str = "qkv_w", rows: int = 1) -> bool:
    """Quantized serving's dispatch (``gpt2.py:247``): run the layer loop
    with the stacked w8a8 kernel selecting each layer in-kernel when the
    blocks are K-grouped records, the stacked kernel is on, the call has at
    most ``W8A8_MAX_ROWS`` rows, and ``DS_INDEXED_DECODE`` is not ``0``."""
    from ..ops.quantized_matmul import W8A8_MAX_ROWS, stacked_kernel_enabled

    return (quant.is_k_quantized(blocks[probe])
            and stacked_kernel_enabled()
            and rows <= W8A8_MAX_ROWS
            and os.environ.get("DS_INDEXED_DECODE", "1") != "0")


def _dequant_resident(params, dtype=None):
    """Expand weight-only records outside ``blocks`` (embeddings, final LN)
    up front; the stacked blocks stay int8 (``gpt2.py:265``).  ``dtype``
    defaults to that of the first dense float leaf."""
    leaves = list(quant.tree_leaves(params))
    if not any(quant.is_quantized(v) for v in leaves):
        return params
    if dtype is None:
        dtype = next((v.dtype for v in leaves
                      if isinstance(v, torch.Tensor) and v.is_floating_point()),
                     torch.bfloat16)
    return {k: (quant.dequantize_pytree(v, dtype) if k != "blocks" else v)
            for k, v in params.items()}


def layer_accessors(layer):
    """``(get, mm)`` over a pre-sliced layer (``gpt2.py:233``): ``get(name)``
    a small leaf, ``mm(y, name, dtype)`` the matmul through :func:`_qmm`."""
    return layer.__getitem__, lambda y, name, dtype: _qmm(y, layer[name],
                                                          dtype)


def _qkv(cfg: GPT2Config, get, mm, y):
    """q, k, v as contiguous [B, H, T, hd] tensors."""
    b, t, _ = y.shape
    qkv = mm(y, "qkv_w", None) + get("qkv_b").to(y.dtype)
    return [z.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
            .contiguous() for z in qkv.chunk(3, dim=-1)]


def _mlp_residual(get, mm, x):
    y = _layer_norm(x, get("ln2_scale"), get("ln2_bias"))
    hid = _gelu(mm(y, "fc_w", None) + get("fc_b").to(y.dtype))
    return x + mm(hid, "proj_w", x.dtype) + get("proj_b").to(x.dtype)


def dropout_keep(rng, shape, dropout: float):
    """The attention-dropout keep mask of one layer: ``jax.random.
    bernoulli(rng, 1 - dropout, shape)``, i.e. ``uniform(rng, shape) < 1 -
    dropout`` in float32, bit for bit (``rng`` an int64 ``[2]`` key on the
    mask's device)."""
    keep_p = float(np.float32(1.0 - dropout))
    return uniform(rng, shape) < keep_p


def _block(cfg: GPT2Config, x, layer, rng=None, dropout: float = 0.0):
    """One transformer block (``gpt2.py:285``): flash attention or einsum
    attention by ``cfg.use_flash``; with ``dropout > 0`` einsum, the
    probabilities dropped by the keep mask of ``rng`` (module
    docstring)."""
    b, s, d = x.shape
    get, mm = layer_accessors(layer)
    y = _layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    q, k, v = _qkv(cfg, get, mm, y)
    use_flash = cfg.use_flash
    if use_flash is None:
        use_flash = x.is_cuda
    if use_flash and dropout == 0.0:
        attn = flash_attention(q, k, v, causal=True,
                               block_q=cfg.flash_block_q,
                               block_k=cfg.flash_block_k)
    else:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / \
            math.sqrt(cfg.head_dim)
        scores = torch.where(mask, scores.float(), -1e9)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        if dropout > 0.0 and rng is not None:
            probs = probs * dropout_keep(rng, probs.shape, dropout) / \
                (1.0 - dropout)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + mm(attn, "o_w", x.dtype) + get("o_b").to(x.dtype)
    return _mlp_residual(get, mm, x)


def _embed(cfg: GPT2Config, params: Params, input_ids):
    """Token + position embeddings [B, S, D] in the dtype of
    ``params["wte"]``."""
    del cfg
    s = input_ids.shape[1]
    return (params["wte"][input_ids] + params["wpe"][:s]).to(
        params["wte"].dtype)


def _trunk(cfg: GPT2Config, params: Params, input_ids, rng=None,
           train: bool = True):
    """Embeddings + all blocks: pre-final-LN activations [B, S, D]
    (``gpt2.py:591``), in the dtype of ``params["wte"]``.  Layer ``i``
    drops attention probabilities with the key ``fold_in(rng, i)`` when
    training with ``dropout > 0``; with ``cfg.remat`` and autograd on,
    each block is recomputed in the backward under ``cfg.remat_policy``."""
    x = _embed(cfg, params, input_ids)
    dropout = cfg.dropout if train else 0.0
    remat = cfg.remat and torch.is_grad_enabled()
    if rng is not None and dropout > 0.0:
        rng = torch.as_tensor(rng, dtype=torch.int64).to(x.device)
    for i in range(cfg.num_layers):
        layer = _layer(params["blocks"], i)
        r = fold_in(rng, i) if (rng is not None and dropout > 0.0) else None
        if remat:
            x = checkpoint_block(
                lambda x, layer, r: _block(cfg, x, layer, r, dropout),
                x, layer, r, policy=cfg.remat_policy,
                offload=cfg.remat_offload)
        else:
            x = _block(cfg, x, layer, r, dropout)
    return x


def forward(cfg: GPT2Config, params: Params, input_ids):
    """Token logits [B, S, V] (``gpt2.py:354``). input_ids: [B, S] ints."""
    params = _dequant_resident(params)
    x = _trunk(cfg, params, input_ids)
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["wte"].T.to(x.dtype)


def _head_loss(cfg: GPT2Config, params: Params, x, targets):
    """Final LN + tied head + mean next-token cross entropy as
    ``lse - label_logit`` over the targets that are not ``-100``
    (``gpt2.py:699``).  The JAX package checkpoints this head to keep the
    [T, V] logits out of its saved activations; here autograd keeps them,
    which an 80 GB card holds at GPT-2 size (``fused_ce`` keeps at most a
    chunk of them: :func:`_head_loss_fused`)."""
    del cfg
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    logits = x @ params["wte"].T.to(x.dtype)
    valid = targets >= 0
    safe = torch.where(valid, targets, 0)
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0].float()
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def _mm_f32(a, b):
    """``a @ b`` with a float32 result (JAX's ``preferred_element_type=
    jnp.float32``): 16-bit CUDA operands stay on the tensor cores with an
    f32 accumulator and output (``torch.mm(..., out_dtype=)``); float32
    operands, and the CPU, multiply in float32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedCE(torch.autograd.Function):
    """The chunked CE over a tied head (``_fused_ce`` / ``_fused_ce_fwd`` /
    ``_fused_ce_bwd``, ``gpt2.py:715-797``): the forward computes the loss
    AND the unscaled float32 cotangents of the input and the weight chunk
    by chunk (``dlogits = softmax - onehot``, over the valid targets' count),
    so three [N, D] x [D, V] products run instead of four and at most
    [N / n_chunks, V] logits are live.  The backward multiplies them by the
    upstream cotangent (under fp16 the loss scale) and only then casts
    them to the parameters' dtypes, so unscaled fp16 gradients never flush
    to subnormals.  The products are plain matmuls, as JAX leaves them to
    XLA."""

    @staticmethod
    def forward(ctx, w, x2d, targets, n_chunks: int):
        n, d = x2d.shape
        c = n // n_chunks
        denom = (targets >= 0).sum().clamp(min=1).float()
        loss = torch.zeros((), dtype=torch.float32, device=x2d.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dxs = []
        for i in range(n_chunks):
            xc, tc = x2d[i * c:(i + 1) * c], targets[i * c:(i + 1) * c]
            logits = _mm_f32(xc, w)                          # [c, V]
            valid = tc >= 0
            safe = torch.where(valid, tc, 0)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, safe[:, None])[:, 0]
            loss += torch.where(valid, lse - picked, 0.0).sum() / denom
            g = torch.exp(logits - lse[:, None])
            g[torch.arange(c, device=g.device), safe] -= 1.0
            g = torch.where(valid[:, None], g, 0.0) / denom
            gc = g.to(w.dtype)
            dxs.append(_mm_f32(gc, w.T))                     # [c, D]
            dw += _mm_f32(xc.T, gc)                          # [D, V]
        ctx.save_for_backward(dw, torch.cat(dxs))
        ctx.dtypes = (w.dtype, x2d.dtype)
        return loss

    @staticmethod
    def backward(ctx, ct):
        dw, dx = ctx.saved_tensors
        ct = ct.float()
        return ((ct * dw).to(ctx.dtypes[0]), (ct * dx).to(ctx.dtypes[1]),
                None, None)


def _head_loss_fused(cfg: GPT2Config, params: Params, x, targets):
    """LN + the tied head's CE through :class:`_FusedCE`
    (``_head_loss_fused``, ``gpt2.py:797``): ``ce_chunks`` chunks, stepped
    down until they divide the B * S rows."""
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    b, s, d = x.shape
    n = b * s
    n_chunks = cfg.ce_chunks
    while n % n_chunks:
        n_chunks -= 1
    return _FusedCE.apply(params["wte"].T.to(x.dtype), x.reshape(n, d),
                          targets.reshape(n), n_chunks)


def loss_from_batch(cfg: GPT2Config, params: Params, batch, rng=None,
                    train: bool = True):
    """Next-token cross entropy (``gpt2.py:650``).  ``batch``:
    ``{"input_ids": [B, S]}`` (the targets are the ids shifted by one, so
    the model sees S - 1 positions), ``{"input_ids", "labels"}`` or an
    ``(input_ids, labels)`` pair; labels of -100 are ignored.  ``rng`` (a
    JAX-layout key) and ``train`` select attention dropout; ``fused_ce``
    takes the fused head."""
    if isinstance(batch, (tuple, list)):
        input_ids, labels = batch
    else:
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
    if labels is None:
        labels = input_ids[:, 1:]
        input_ids = input_ids[:, :-1]
    x = _trunk(cfg, params, input_ids, rng, train)
    if cfg.fused_ce:
        return _head_loss_fused(cfg, params, x, labels)
    return _head_loss(cfg, params, x, labels)


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


def _block_cached_body(cfg: GPT2Config, x, get, mm, ck, cv, pos,
                       block_tables=None, chunk_valid=None):
    """One block with KV-cache read/write (``gpt2.py:413``), with weight
    access through ``get(name)`` / ``mm(y, name, dtype)`` so the per-layer
    and layer-indexed loops share the math.  x: [B, T, D]; ck/cv: one
    layer's cache or pool slice (or int8 pool record), written in place;
    pos: the global position of x[:, 0] — int, or int32 [B] per-row
    positions."""
    b, t, d = x.shape
    y = _layer_norm(x, get("ln1_scale"), get("ln1_bias"))
    q, k, v = _qkv(cfg, get, mm, y)
    attn = _cached_attention(q, k, v, ck, cv, pos, block_tables, chunk_valid)
    attn = attn.transpose(1, 2).reshape(b, t, d)
    x = x + mm(attn, "o_w", x.dtype) + get("o_b").to(x.dtype)
    return _mlp_residual(get, mm, x)


def _stepwise(mm):
    """``mm`` applied one window position at a time: ``[B, 1, D]``
    contiguous operands, a single-token decode step's shapes."""
    def per_position(y, name, dtype):
        return torch.cat([mm(y[:, i:i + 1].contiguous(), name, dtype)
                          for i in range(y.shape[1])], dim=1)
    return per_position


def _stack_len(leaf) -> int:
    """Layers of a stacked leaf or record."""
    if quant.is_record(leaf):
        leaf = leaf.get("qk", leaf.get("q"))
    return leaf.shape[0]


def decode_over_layers(body, x, blocks: Params, cache_k, cache_v,
                       num_layers: int, probe: str = "qkv_w",
                       stepwise: bool = False, rows: Optional[str] = None):
    """Run ``body(x, get, mm, ck, cv) -> x`` over all layers
    (``gpt2.py:442``), each layer's cache leaves (or int8 pool records)
    written in place: a loop over pre-sliced layers (:func:`layer_accessors`)
    normally, or, with K-grouped blocks and the stacked kernel on
    (:func:`use_indexed_decode` on ``blocks[probe]``), a loop whose
    matmuls select the layer in the stacked w8a8 kernel, the index a slice
    of one ``arange(L)`` on the device.  ``stepwise`` runs every matmul one
    window position at a time (:func:`_stepwise`: the speculative verify's
    all-position window), and the indexed gate then counts one position's
    rows.  ``rows`` (``"prefill"`` or ``"decode"``) runs every matmul (each
    position's, stepwise) on the row counts of ``utils.rows.fixed_rows``
    (llama and OPT: a row's bits then do not depend on its call's other
    rows).  Raises when the stack does not hold ``num_layers`` layers, as
    ``lax.scan`` would."""
    n_stack = _stack_len(next(iter(blocks.values())))
    if n_stack != num_layers:
        raise ValueError(f"stacked blocks carry {n_stack} layers but "
                         f"num_layers={num_layers}")
    b, t = x.shape[0], x.shape[1]
    indexed = use_indexed_decode(blocks, probe,
                                 rows=b if stepwise else b * t)
    if indexed:
        layer_ids = torch.arange(num_layers, dtype=torch.int32,
                                 device=x.device)
    for i in range(num_layers):
        layer = _layer(blocks, i)
        if indexed:
            def mm(y, name, dtype, l_idx=layer_ids[i:i + 1]):
                return _qmm_indexed(y, blocks[name], l_idx, dtype)

            get, mm = layer.__getitem__, _row_rule(mm, rows, stepwise)
        else:
            get, mm = cached_layer_accessors(layer, x.dtype, rows, stepwise)
        x = body(x, get, mm, _index(cache_k, i), _index(cache_v, i))
    return x


def _row_rule(mm, rows: Optional[str], stepwise: bool):
    """``mm`` on the row counts of ``utils.rows`` (``rows``), one window
    position at a time when ``stepwise``."""
    if rows is not None:
        mm = fixed_row_mm(mm, rows)
    if stepwise:
        mm = _stepwise(mm)
    return mm


def cached_layer_accessors(layer: Params, dtype, rows: Optional[str] = None,
                           stepwise: bool = False):
    """``(get, mm)`` of one pre-sliced layer on the cached path, as
    :func:`decode_over_layers` builds them for a layer it does not index
    in the stacked kernel; a streamed layer (``inference/
    zero_inference.py``) takes them too, so it computes the resident
    layer's bits.  A K-grouped record of a ``"prefill"`` window is
    expanded once for all its row blocks (w8a8 above 8 rows is dequantize
    + matmul, bit for bit the per-block one); a 2-D record of a decode
    step of at most ``W8A8_MAX_ROWS`` rows runs the w8a8 kernel (B5), the
    bits of the stacked one (B6)."""
    if rows == "prefill":
        layer = {k: quant.dequantize_k(v, dtype)
                 if quant.is_k_quantized(v) else v
                 for k, v in layer.items()}
    get, mm = layer_accessors(layer)
    return get, _row_rule(mm, rows, stepwise)


def forward_cached(cfg: GPT2Config, params: Params, input_ids, cache, pos,
                   lengths=None, block_tables=None, all_positions=False):
    """Incremental forward (``gpt2.py:503``): logits for the LAST input
    position (or every position with ``all_positions``, the speculative
    verify head) and the cache, written in place.  With
    ``all_positions`` every dense matmul, the head's included, runs one
    window position at a time on ``[B, D]`` operands, the decode step's
    shapes: a GEMM library picks its kernel, and so a row's summation
    order, by the row count, so only those shapes give each position the
    single-token decode step's bits (w8a8 records then take the decode
    step's route too) and speculative greedy decoding stays token-exact
    with plain decoding.  Three position modes, as in the JAX function:

     - ``lengths`` given and T == 1 (per-row decode): row ``b``'s token sits
       at position ``lengths[b]``; ``pos`` is ignored.
     - ``block_tables`` given and ``pos`` an int32 [B] tensor (chunked
       prefill): row ``b``'s T-token window starts at ``pos[b]``;
       ``lengths`` counts its real tokens (pads write to scratch) and picks
       the returned logits at ``lengths[b] - 1``.
     - otherwise ``pos`` is one int shared by every row; a ``lengths``
       vector with T > 1 picks each row's logits at ``lengths[b] - 1``.

    ``cache`` is ``{"k", "v"}`` of ``[L, B, H, S, hd]`` (contiguous) or
    ``[L, NB, H, bs, hd]`` (paged, with ``block_tables`` int32 [B, NBPER]),
    each leaf possibly an int8 pool record.  The layer loop is
    :func:`decode_over_layers`: with K-grouped blocks and at most
    ``W8A8_MAX_ROWS`` rows it takes the stacked w8a8 kernel, each layer's
    index a slice of one ``arange(L)`` on the device
    (:func:`use_indexed_decode`).
    """
    params = _dequant_resident(params)
    t = input_ids.shape[1]
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
    stepwise = all_positions and t > 1
    x = decode_over_layers(
        lambda x, get, mm, ck, cv: _block_cached_body(
            cfg, x, get, mm, ck, cv, step_pos, block_tables=block_tables,
            chunk_valid=chunk_valid),
        x, params["blocks"], cache["k"], cache["v"], cfg.num_layers,
        stepwise=stepwise)
    if not all_positions:
        x = _gather_last(x, lengths if not per_row else None)
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    head = (lambda y, name, dtype: y @ params["wte"].T.to(dtype))
    if stepwise:
        head = _stepwise(head)
    return head(x, "wte", x.dtype), cache


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
    the random initializer, the training ``loss_fn`` and
    ``flops_per_token``, and the ``decode_hooks`` the engines read
    (``gpt2.py:810-867``).  Parameters live with the engine, as a nested
    dict of tensors, so one model object can back several engines."""

    #: the engines may store ``blocks`` as int8 records (module docstring)
    quant_aware = True
    #: where the stacked per-layer weights live in the parameter tree
    blocks_key = ("blocks",)
    #: the inference engine draws default weights in f32 from a host
    #: generator (``init_fn`` draws on the generator's device)
    init_on_device = False

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.model_config = cfg
        self.name = f"gpt2-{cfg.num_layers}l-{cfg.hidden_size}d"
        self.flops_per_token = 6.0 * cfg.num_params()
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
            # all-position logits over a K+1 window (speculative verify)
            "supports_verify": True,
            # every pool read and write goes through ops/paged_kv and the
            # record-aware attention, so the server may quantize the pool
            "supports_kv_quant": True,
            # full-vocab logits feed the on-device sampler unchanged
            "supports_sampling": True,
        }
        # the block-structured view the parameter-streaming engine drives
        # (``gpt2.py:827-831``): embeddings, one block, final LN + head loss
        self.pipeline_hooks = {
            "blocks_key": ("blocks",),
            "embed_fn": lambda params, ids: _embed(cfg, params, ids),
            "block_fn": lambda layer, x, rng=None: _block(
                cfg, x, layer, rng, cfg.dropout if rng is not None else 0.0),
            "head_loss_fn": lambda params, x, tgt: _head_loss(cfg, params, x,
                                                              tgt),
            "dropout": cfg.dropout,
        }

    def init_fn(self, generator: torch.Generator) -> Params:
        return init_params(self.model_config, generator)

    def loss_fn(self, params: Params, batch, rng=None, train: bool = True):
        return loss_from_batch(self.model_config, params, batch, rng, train)

    def forward(self, params: Params, input_ids):
        return forward(self.model_config, params, input_ids)


def build(cfg: Optional[GPT2Config] = None, **overrides) -> GPT2Model:
    return GPT2Model(cfg or GPT2Config(**overrides))
