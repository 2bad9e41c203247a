"""Group-wise int8 quantization records — the PyTorch port of
``deepspeed_tpu/ops/quantization.py``.

Three record kinds, each a plain dict of tensors, with the JAX package's
layouts so a record moves between the packages leaf for leaf
(``models.gpt2.params_from_jax``):

 - **weight-only** (``quantize``): ``{"q": int8 w.shape, "scale": f32
   [..., N/G]}`` (``"zero"`` too when asymmetric), groups along the LAST
   axis; consumed by ``ops.quantized_matmul.quantized_matmul`` (B7) or
   expanded by :func:`dequantize`.
 - **K-grouped w8a8** (``quantize_k_grouped``): ``{"qk": int8 [..., K, N],
   "kscale": f32 [..., K/G, 1, N]}``, scales constant over each k-group of
   the contraction axis so they factor out of the int8 dot; consumed by
   ``ops.quantized_matmul.w8a8_matmul`` / ``w8a8_matmul_stacked`` (B5/B6).
 - **int8 KV vectors** (``quantize_kv``): codes plus one bf16 scale per
   token vector, the payload of the kv8 pool records of ``ops/paged_kv.py``.

Everything here is plain PyTorch and runs on whatever device its inputs
live on (the inference engine quantizes on its own device, one layer of the
stacked blocks at a time).  Codes and scales
equal the JAX package's bit for bit: the same f32 operations in the same
order, ``torch.round`` rounding half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import torch

PyTree = Any

_QKEYS = frozenset({"q", "scale", "zero"})
_QK_KEYS = frozenset({"qk", "kscale"})


def is_quantized(leaf) -> bool:
    """True for a weight-only record produced by :func:`quantize`."""
    return isinstance(leaf, dict) and _QKEYS.issuperset(leaf) and "q" in leaf


def is_k_quantized(leaf) -> bool:
    """True for a K-grouped record produced by :func:`quantize_k_grouped`."""
    return isinstance(leaf, dict) and _QK_KEYS == set(leaf)


def is_record(leaf) -> bool:
    """True for either weight record kind — the tree walks' leaf test."""
    return is_quantized(leaf) or is_k_quantized(leaf)


def _where_zero(x: torch.Tensor, ones_at_zero_of: torch.Tensor):
    return torch.where(ones_at_zero_of == 0, torch.ones_like(x), x)


@functools.lru_cache(maxsize=None)
def _constant(value: float, device: torch.device, dtype: torch.dtype):
    return torch.tensor(value, dtype=dtype, device=device)


def ieee_div(a, b) -> torch.Tensor:
    """``a / b`` rounded once, as the JAX package and the CUDA kernels
    divide; one side may be a Python number.  PyTorch computes ``number /
    tensor`` everywhere, and ``tensor / number`` on CUDA, as a product with
    a reciprocal, which can land an ulp away and then move an int8 code or
    a bf16 output."""
    if not isinstance(a, torch.Tensor):
        a = _constant(float(a), b.device, b.dtype)
    if not isinstance(b, torch.Tensor):
        b = _constant(float(b), a.device, a.dtype)
    return torch.div(a, b)


def quantize(w: torch.Tensor, num_bits: int = 8, group_size: int = 64,
             symmetric: bool = True) -> dict:
    """w: float tensor, last dim divisible by ``group_size`` ->
    ``{"q": int8 (w.shape), "scale": f32 [..., G], ["zero": f32 [..., G]]}``
    (``quantization.py:36``)."""
    if num_bits != 8:
        raise ValueError(f"int8 storage only (num_bits=8), got {num_bits}")
    shape = tuple(w.shape)
    if shape[-1] % group_size:
        raise ValueError(f"last dim of {shape} does not divide into groups "
                         f"of {group_size}")
    g = w.to(torch.float32).reshape(shape[:-1] + (-1, group_size))
    if symmetric:
        amax = g.abs().amax(dim=-1)
        scale = _where_zero(ieee_div(amax, 127.0), amax)
        q = torch.clamp(torch.round(g / scale[..., None]), -127, 127)
        return {"q": q.to(torch.int8).reshape(shape), "scale": scale}
    lo = g.amin(dim=-1)
    hi = g.amax(dim=-1)
    scale = _where_zero(ieee_div(hi - lo, 255.0), hi - lo)
    zero = lo
    q = torch.clamp(torch.round((g - zero[..., None]) / scale[..., None]),
                    0, 255) - 128
    return {"q": q.to(torch.int8).reshape(shape), "scale": scale,
            "zero": zero}


def dequantize(rec: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Expand a weight-only record in f32, cast once (``:60``); the group
    size is ``q.shape[-1] // scale.shape[-1]``."""
    q = rec["q"]
    gs = q.shape[-1] // rec["scale"].shape[-1]
    shape = tuple(q.shape)
    g = q.to(torch.float32).reshape(shape[:-1] + (-1, gs))
    if "zero" in rec:
        w = (g + 128.0) * rec["scale"][..., None] + rec["zero"][..., None]
    else:
        w = g * rec["scale"][..., None]
    return w.reshape(shape).to(dtype)


def _is_norm_path(path) -> bool:
    """True when a key path names a norm / bias / scale parameter (those
    stay dense whatever their shape)."""
    flat = "/".join(str(k) for k in path).lower()
    return any(t in flat for t in
               ("ln", "norm", "bias", "scale", "gamma", "beta"))


def _map_with_path(fn: Callable, tree: PyTree, path=()) -> PyTree:
    """``jax.tree_util.tree_map_with_path`` over nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _is_weight_matrix(x, path, min_size: int, min_ndim: int) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.ndim >= max(min_ndim, 2) and x.numel() >= min_size
            and not _is_norm_path(path))


def _by_layer(fn: Callable, x: torch.Tensor, device) -> dict:
    """``fn(x)`` of a stacked ``[L, ...]`` leaf computed one layer at a time
    on ``device`` and stacked into records there.  Equal bit for bit to
    ``fn(x)`` when ``fn``'s groups never span the leading axis (every
    quantizer here); its temporaries are one layer's, not the stack's."""
    out = None
    for i in range(x.shape[0]):
        rec = fn(x[i].to(device))
        if out is None:
            out = {k: torch.empty((x.shape[0],) + tuple(v.shape),
                                  dtype=v.dtype, device=device)
                   for k, v in rec.items()}
        for k, v in rec.items():
            out[k][i] = v
    return out


def _quantizer(fn: Callable, device):
    """``fn`` on a whole leaf, or layer by layer on ``device``."""
    if device is None:
        return fn
    return lambda x: _by_layer(fn, x, device)


def quantize_pytree(params: PyTree, num_bits: int = 8, group_size: int = 64,
                    symmetric: bool = True, min_size: int = 4096,
                    min_penultimate: int = 64, min_ndim: int = 2,
                    device=None) -> PyTree:
    """Quantize weight-matrix-like float leaves, others pass through
    (``:81``): at least ``min_size`` elements and ``min_ndim`` (>= 2) dims,
    a last dim divisible by ``group_size``, ``shape[-2] >=
    min_penultimate``, and no norm/bias/scale name on the path.  Callers
    quantizing a stacked-blocks subtree pass ``min_ndim=3``, which keeps
    every per-layer bias ``[L, d]`` dense; with ``device`` too, each
    eligible stacked leaf is quantized one layer at a time on ``device``
    (the same records)."""
    q = _quantizer(lambda x: quantize(x, num_bits, group_size, symmetric),
                   device)

    def one(path, x):
        if (_is_weight_matrix(x, path, min_size, min_ndim)
                and x.shape[-1] % group_size == 0
                and x.shape[-2] >= min_penultimate):
            return q(x)
        return x

    return _map_with_path(one, params)


def _map_records(fn: Callable, tree: PyTree) -> PyTree:
    if is_record(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_records(fn, v) for k, v in tree.items()}
    return fn(tree)


def dequantize_pytree(params: PyTree, dtype=torch.bfloat16) -> PyTree:
    """Inverse of :func:`quantize_pytree` (``:113``)."""
    return _map_records(
        lambda x: dequantize(x, dtype) if is_quantized(x) else x, params)


def tree_leaves(tree: PyTree):
    """Leaves of a nested dict, records counted as one leaf each."""
    if is_record(tree) or not isinstance(tree, dict):
        yield tree
        return
    for v in tree.values():
        yield from tree_leaves(v)


def quantized_nbytes(params: PyTree) -> int:
    """Storage accounting, int8 payload + f32 scales (``:121``)."""
    total = 0
    for leaf in tree_leaves(params):
        if is_quantized(leaf):
            total += leaf["q"].numel() + leaf["scale"].numel() * 4
            if "zero" in leaf:
                total += leaf["zero"].numel() * 4
        else:
            for t in (leaf.values() if is_k_quantized(leaf) else (leaf,)):
                if isinstance(t, torch.Tensor):
                    total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------- w8a8
def pick_k_group(k_dim: int, cap: int, shard_multiple: int = 1) -> int:
    """Largest k-group ``g <= cap``, a multiple of 8 dividing ``k_dim``,
    with whole groups on every one of ``shard_multiple`` row shards when
    ``k_dim`` divides over them; 0 when none exists (``:160``).  The
    multiple-of-8 rule is the TPU's sublane quantum, kept so records stay
    bit-identical to the JAX package's."""
    need_align = shard_multiple > 1 and k_dim % shard_multiple == 0
    g = (min(cap, k_dim) // 8) * 8
    while g >= 8:
        if k_dim % g == 0 and (
                not need_align or (k_dim // g) % shard_multiple == 0):
            return g
        g -= 8
    return 0


def quantize_k_grouped(w: torch.Tensor, k_group: int = 256) -> dict:
    """w: [..., K, N] float, K divisible by ``k_group`` -> ``{"qk": int8
    (w.shape), "kscale": f32 [..., K/G, 1, N]}`` (``:216``)."""
    shape = tuple(w.shape)
    k_dim, n_dim = shape[-2], shape[-1]
    if k_dim % k_group:
        raise ValueError(f"K={k_dim} of {shape} does not divide into "
                         f"k-groups of {k_group}")
    g = w.to(torch.float32).reshape(
        shape[:-2] + (k_dim // k_group, k_group, n_dim))
    amax = g.abs().amax(dim=-2, keepdim=True)                 # [.., K/G, 1, N]
    scale = _where_zero(ieee_div(amax, 127.0), amax)
    qk = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return {"qk": qk.reshape(shape), "kscale": scale}


def dequantize_k(rec: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Expand a K-grouped record in f32, cast once (``:270``), any number
    of leading dims (a stack ``[L, ...]``, experts ``[E, ...]`` or both).
    One elementwise pass: the codes promote to f32 against the f32 scales
    and each product is rounded to ``dtype`` as it is stored, the bits of
    ``(qk.float() * scale).to(dtype)`` without its two f32 temporaries (a
    layer of Mixtral-8x7B's experts is 1.4 G codes)."""
    qk, scale = rec["qk"], rec["kscale"]
    shape = tuple(qk.shape)
    k_group = shape[-2] // scale.shape[-3]
    g = qk.reshape(shape[:-2] + (shape[-2] // k_group, k_group, shape[-1]))
    out = torch.empty(g.shape, dtype=dtype, device=qk.device)
    torch.mul(g, scale.to(torch.float32), out=out)
    return out.reshape(shape)


def quantize_pytree_k_grouped(params: PyTree, k_group: int = 256,
                              min_size: int = 4096, min_ndim: int = 2,
                              shard_multiple: int = 1,
                              device=None) -> PyTree:
    """The w8a8 variant of :func:`quantize_pytree` (``:291``): the same
    weight-matrix selection (``min_ndim=3`` for stacked blocks), with
    ``K % k_group == 0`` and ``N % 128 == 0``; an eligible leaf's group
    size refines through :func:`pick_k_group` by ``shard_multiple``
    (uniformly: the JAX package's ``spec_tree`` refinement waits for the
    multi-GPU slice), so records are bit-identical to the JAX package's
    for the same ``quant.shard_multiple``.  ``device`` as in
    :func:`quantize_pytree`."""
    def one(path, x):
        if (_is_weight_matrix(x, path, min_size, min_ndim)
                and x.shape[-2] % k_group == 0 and x.shape[-1] % 128 == 0):
            g = pick_k_group(x.shape[-2], k_group, shard_multiple) or k_group
            return _quantizer(lambda w: quantize_k_grouped(w, g), device)(x)
        return x

    return _map_with_path(one, params)


# ------------------------------------------------------------- int8 KV cache
def quantize_kv(x: torch.Tensor, scale_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the LAST axis (``:250``): ``(codes int8
    x.shape, scale scale_dtype x.shape[:-1])`` with ``dequant = codes *
    scale[..., None]``.  Codes are computed against the ROUNDED stored
    scale so a write and its read agree; an all-zero vector stores scale 1
    and codes 0."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    scale = _where_zero(ieee_div(amax, 127.0), amax).to(scale_dtype)
    codes = torch.clamp(torch.round(x32 / scale[..., None].to(torch.float32)),
                        -127, 127).to(torch.int8)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: f32 expand, cast once (``:264``)."""
    return (codes.to(torch.float32) *
            scale[..., None].to(torch.float32)).to(dtype)
