"""On-device sampling primitives for the serving engine — the PyTorch port
of ``deepspeed_tpu/ops/sampling.py``, with the same names and meaning.

Everything here is shaped so the scheduler can keep *per-slot* sampling
state in fixed-shape operands — ``[slots]`` knob vectors and ``[slots]``
counter vectors — that a captured decode graph reads: a slot changing
temperature, or a mixed greedy + sampled batch, changes operand *values*,
never the graph.

Greedy is the ``temperature == 0`` row of the same computation:
:func:`filtered_logprobs` returns the exact one-hot (``0 / -inf``)
distribution at the argmax for those rows, so :func:`sample_tokens` on
them is the argmax, with no branch.

**Counter-based PRNG, bit for bit JAX's.** The key of any draw is
``fold_in(fold_in(PRNGKey(seed), salt), position)``, ``position`` the
absolute emitted-token index, so keys are a pure function of ``(seed,
salt, position)`` and preemption replays a stream token for token.  The
keys, the random bits, :func:`uniform`, :func:`gumbel` and
:func:`categorical` reproduce JAX's threefry2x32 implementation
(``jax/_src/prng.py``, ``jax/_src/random.py``, jax 0.9.0):

 - ``PRNGKey(seed)`` is the word pair ``[0, seed & 0xFFFFFFFF]``: JAX's
   default 32-bit mode takes the seed as an int32, so the high word is 0;
 - ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
 - the bits of a draw of shape ``S`` (``jax_threefry_partitionable``,
   True in jax 0.9.0) hash the row-major flat index of each element, as
   the counter pair ``(index >> 32, index & 0xFFFFFFFF)``, and give
   ``bits1 ^ bits2``;
 - ``uniform`` ORs the top 23 bits into the mantissa of 1.0, subtracts
   1, scales to ``[minval, maxval)`` and clamps at ``minval``;
 - ``gumbel`` (mode ``"low"``, the default) is ``-log(-log(u))`` with
   ``u`` uniform on ``[tiny, 1)``; ``categorical`` is ``argmax(logits +
   gumbel)``; ``normal`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
   ``[nextafter(-1, 0), 1)`` and XLA's float32 ``erf_inv`` polynomial.

Identical logits therefore give identical draws, up to the last ulp of
``log`` (PyTorch's and XLA's may differ there: a draw moves only where
two perturbed scores tie to that ulp).

**Integer arithmetic.** PyTorch's ``uint32`` support is partial, so the
32-bit words live in ``int64`` tensors: every sum is masked to 32 bits,
and ``>>`` of a non-negative ``int64`` is a logical shift.  Keys are
``int64 [..., 2]`` tensors holding the two uint32 words.

The salts separate the independent sub-streams one emission consumes:
``SALT_TOKEN`` plain next-token draws (decode, the fused window, the
prefill's first token); ``SALT_ACCEPT`` / ``SALT_RESIDUAL`` /
``SALT_DRAFT`` the speculative verifier's draws (ROADMAP Queue A 3).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "SALT_TOKEN", "SALT_ACCEPT", "SALT_RESIDUAL", "SALT_DRAFT",
    "slot_keys", "grid_keys", "filtered_logprobs", "sample_tokens",
    "accept_uniforms", "token_probs", "residual_logits",
]

SALT_TOKEN = 1
SALT_ACCEPT = 2
SALT_RESIDUAL = 3
SALT_DRAFT = 4

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000                 # float32 1.0
_TINY = float(np.finfo(np.float32).tiny)


def _words(x):
    """``x`` as uint32 words: an integer tensor as int64 masked to 32
    bits, a Python int as a Python int (never copied to the device: the
    decode step may run under CUDA-graph capture)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _fresh(v, shape, device) -> torch.Tensor:
    """A new int64 tensor of ``shape`` holding ``v`` (tensor or int)."""
    if isinstance(v, torch.Tensor):
        return v.expand(shape).clone(memory_format=torch.contiguous_format)
    return torch.full(shape, v, dtype=torch.int64, device=device)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)`` under the key ``(k1, k2)``, elementwise over broadcast int64
    word tensors (Python ints broadcast as scalars; at least one argument
    is a tensor): ``jax/_src/prng.py::_threefry2x32_lowering``.  The
    running sum ``x0`` is masked once a group of four rounds (it stays
    below 2**35); ``x1`` is masked after each rotation."""
    tensors = [t for t in (k1, k2, x1, x2) if isinstance(t, torch.Tensor)]
    device = tensors[0].device
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    k1, k2, x1, x2 = (_words(t) for t in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = _fresh(x1 + ks[0], shape, device)
    x1 = _fresh(x2 + ks[1], shape, device)
    x1 &= _M32
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            torch.bitwise_left_shift(x1, r, out=t)
            x1 >>= 32 - r
            x1 |= t
            x1 ^= x0
            x1 &= _M32
        x0 += ks[(i + 1) % 3]
        x0 &= _M32
        x1 += ks[(i + 2) % 3] + (i + 1)
        x1 &= _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with ``jax_enable_x64`` off (JAX's
    default): ``[0, seed & 0xFFFFFFFF]`` as an int64 ``[2]`` tensor, for
    any Python or numpy integer (negative, or at or past 2**32, included)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``threefry2x32(key, (0, data))`` for keys
    ``[..., 2]`` and data broadcast against their leading dims."""
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([a, b], dim=-1)


def fold_in_words(key: Sequence[int], data: int):
    """:func:`fold_in` of one key held as two Python ints (the same bits,
    the same masking mod 2**32): for keys the host derives every step,
    where a few hundred tiny tensor operations would cost ~1 ms."""
    k1, k2 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = ks[0], (int(data) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words of ``shape`` per key (``keys [..., 2]``) ->
    ``int64 [*keys.shape[:-1], *shape]``: each element hashes its
    row-major flat index within ``shape`` as the counter pair ``(index >>
    32, index & 0xFFFFFFFF)`` and gives ``bits1 ^ bits2`` (the
    partitionable layout of ``_threefry_random_bits_partitionable``)."""
    shape = tuple(int(s) for s in shape)
    lead = keys.shape[:-1]
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=keys.device).reshape(shape)
    view = lead + (1,) * len(shape)
    b1, b2 = threefry2x32(keys[..., 0].reshape(view),
                          keys[..., 1].reshape(view), idx >> 32, idx & _M32)
    return b1 ^ b2


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """float32 in ``[0, 1)`` from 32-bit words: the top 23 bits OR-ed into
    the mantissa of 1.0, minus 1 (``random.py::_uniform``)."""
    return ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) \
        - 1.0


def uniform(keys: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 per key: ``[*keys.shape[:-1],
    *shape]`` on ``[minval, maxval)``; ``maxval - minval`` is rounded to
    float32 first, as JAX computes it, and ``u * span + minval`` is
    rounded once, as XLA's fused multiply-add does (in float64, where the
    product of two float32 values is exact; with ``span == 1``, the
    sampler's case, the float32 sum is that already)."""
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    u = _unit_floats(random_bits(keys, shape))
    if span == 1.0:
        u = u + lo
    else:
        u = (u.double() * span + lo).float()
    return torch.clamp_min(u, lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, mode ``"low"``) per key:
    ``-log(-log(u))`` for ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


#: XLA's float32 ``erf_inv`` (M. Giles' polynomial in ``w = -log1p(-x²)``):
#: the coefficients for ``w < 5`` and for ``w >= 5``, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Giles' polynomial, each Horner step a
    fused multiply-add (emulated in float64 and rounded once, as
    :func:`uniform` does), ``±1`` mapped to ``±max``.  ``torch.erfinv`` is
    another approximation: 1.7e-5 apart in the tails."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(lt, float(np.float32(a)), float(np.float32(b)))
            .double() for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0].float()
    for c in coef[1:]:
        p = (c + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32 per key (``random.py::
    _normal_real``): ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
    ``[nextafter(-1, 0), 1)`` drawn from the same bits as :func:`uniform`
    (those bit for bit); within an ulp of JAX's where XLA's ``log1p``
    rounds otherwise than torch's."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, shape, lo, 1.0)
    return np.float32(np.sqrt(2.0)).item() * _erf_inv(u)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` with ONE key
    ``[2]`` for the whole ``[..., V]`` logits (the Gumbel noise of the
    whole shape under that key) -> int32 ``[...]``."""
    g = gumbel(key, logits.shape)
    return torch.argmax(g + logits.float(), dim=-1).to(torch.int32)


def slot_keys(seeds, counts, salt) -> torch.Tensor:
    """``[rows, 2]`` keys: ``fold_in(fold_in(PRNGKey(seed), salt),
    count)`` per row — the whole counter-based scheme in one place.
    ``seeds`` hold uint32 values in any integer dtype (an int32 bit
    pattern too), ``counts`` int32 emission indices."""
    k1, k2 = threefry2x32(0, torch.as_tensor(seeds), 0, salt)
    k1, k2 = threefry2x32(k1, k2, 0, torch.as_tensor(counts))
    return torch.stack([k1, k2], dim=-1)


def grid_keys(seeds, counts, salt, width: int) -> torch.Tensor:
    """``[rows, width, 2]`` keys for window draws: row ``s`` position
    ``i`` keys the emission index ``counts[s] + i``."""
    seeds, counts = torch.as_tensor(seeds), torch.as_tensor(counts)
    width = int(width)
    offs = torch.arange(width, dtype=torch.int64, device=counts.device)
    cnts = (counts.to(torch.int64)[:, None] + offs[None, :]).reshape(-1)
    # an expanded view, not repeat_interleave: nothing here may wait for
    # the device (the verify step runs under CUDA-graph capture)
    rows = seeds.to(torch.int64)[:, None].expand(-1, width).reshape(-1)
    return slot_keys(rows, cnts, salt).reshape(-1, width, 2)


def filtered_logprobs(logits, temps, top_k, top_p, masks=None):
    """Per-row log-probs of the filtered sampling distribution
    (``sampling.py:81``): ``[rows, vocab]`` logits + ``[rows]`` knobs ->
    ``(greedy int32 [rows], logprobs float32 [rows, vocab])``.  Per row:
    the bool mask (``-inf`` outside it; an all-False row counts as
    unmasked), scale by ``1/temp``, keep the top-k by the kth-largest
    threshold (``top_k == 0`` = off; ties at the threshold stay in), then
    nucleus-filter at ``top_p`` over the renormalized top-k distribution
    (``top_p == 1`` = off; the token that crosses the boundary stays in).
    Rows with ``temps == 0`` return the exact one-hot (``0 / -inf``) at
    the (masked) argmax."""
    logits = logits.float()
    vocab = logits.shape[-1]
    dev = logits.device
    if masks is not None:
        ok = masks.any(dim=-1, keepdim=True)
        logits = torch.where(torch.where(ok, masks, True), logits,
                             -math.inf)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = torch.as_tensor(temps, device=dev).float()[:, None]
    scaled = logits / torch.clamp_min(temps, 1e-6)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.as_tensor(top_k, device=dev).to(torch.int64)
    kidx = (torch.where(k > 0, k, vocab) - 1).clamp(0, vocab - 1)
    kth = torch.gather(srt, -1, kidx[:, None])
    keep = scaled >= kth
    probs = torch.softmax(torch.where(keep, scaled, -math.inf), dim=-1)
    psort = torch.sort(probs, dim=-1, descending=True).values
    before = torch.cumsum(psort, dim=-1) - psort
    p = torch.as_tensor(top_p, device=dev).float()[:, None]
    thr = torch.where(before < p, psort, math.inf).amin(dim=-1, keepdim=True)
    keep = keep & (probs >= thr)
    logprobs = torch.log_softmax(torch.where(keep, scaled, -math.inf),
                                 dim=-1)
    onehot = torch.where(
        torch.arange(vocab, device=dev)[None, :] == greedy[:, None],
        0.0, -math.inf)
    return greedy, torch.where(temps > 0, logprobs, onehot)


def sample_tokens(logprobs, keys) -> torch.Tensor:
    """One categorical draw per row (``[rows, vocab]`` log-probs +
    ``[rows, 2]`` keys -> int32 ``[rows]``).  One-hot rows come out
    deterministic: the single finite entry wins every Gumbel race."""
    g = gumbel(keys, (logprobs.shape[-1],))
    return torch.argmax(g + logprobs, dim=-1).to(torch.int32)


def accept_uniforms(keys) -> torch.Tensor:
    """One ``U[0, 1)`` per key (any leading shape)."""
    return uniform(keys, ())


def token_probs(logprobs, tokens) -> torch.Tensor:
    """``p(token)`` per row under the filtered distribution (exactly 1.0 /
    0.0 on one-hot rows)."""
    lp = torch.gather(logprobs, -1, tokens.to(torch.int64)[:, None])[:, 0]
    return torch.exp(lp)


def residual_logits(logprobs, tokens) -> torch.Tensor:
    """Rejection-sampler residual per row: the filtered distribution with
    the rejected ``token`` removed; a row with nothing left falls back to
    the one-hot argmax so the unused lane stays NaN-free."""
    vocab = logprobs.shape[-1]
    idx = torch.arange(vocab, device=logprobs.device)[None, :]
    resid = torch.where(idx == tokens.to(torch.int64)[:, None], -math.inf,
                        logprobs)
    dead = ~torch.isfinite(resid).any(dim=-1, keepdim=True)
    onehot = torch.where(idx == torch.argmax(logprobs, dim=-1)[:, None],
                         0.0, -math.inf)
    return torch.where(dead, onehot, resid)
