"""The plain models of the bf16 flash-attention backward kernels
(``flash_attention_bwd_dq_tiled_plain`` / ``_dkv_tiled_plain`` in
``deepspeed_tpu_torch/ops/flash_attention.py``: 64-key tiles for dq,
64-query tiles of the transposed problem for dkv, P and dS rounded to the
input dtype per tile, the rep query heads summed in order) against the JAX
package's ``_bwd_dq_call`` / ``_bwd_dkv_call`` run in interpret mode on the
CPU, as the JAX package's own tests run them, given the same lse and delta.

float32: the forward's o and lse at atol = rtol = 1e-5, dq, dk, dv at 1e-4
(both sum in blocks, in other orders).  bfloat16: element by element
within ``chip_smoke.py``'s ``FLASH_BF16_*`` bars, the bars the CUDA kernels
are held to on the card (the two round P and dS to bf16 at the same places;
``sm_scale`` is a power of two at head dim 16, so folding it into dS before
the cast, as JAX does, rounds alike).  Head dim 16; S = 130 (a full tile
and a ragged one), S = 200 (a causal diagonal inside the second 128-key
tile, split between its two 64-key halves), Sq != Sk, GQA rep 1 and 3.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
D = 16
BLOCK = 32          # the JAX kernels' tiles (inputs padded to a multiple)

# (causal, H, Hkv, Sq, Sk, dtype)
CASES = [
    (True, 2, 2, 130, 130, "float32"),
    (False, 2, 2, 130, 130, "float32"),
    (True, 3, 1, 200, 200, "float32"),
    (False, 3, 1, 72, 104, "float32"),
    (True, 2, 2, 104, 72, "float32"),
    (True, 2, 2, 200, 200, "bfloat16"),
    (False, 3, 1, 130, 130, "bfloat16"),
    (True, 3, 1, 200, 200, "bfloat16"),
    (False, 2, 2, 72, 104, "bfloat16"),
]


def _inputs(seed, h, hkv, sq, sk):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((1, h, sq, D)).astype(f),
            rng.standard_normal((1, hkv, sk, D)).astype(f),
            rng.standard_normal((1, hkv, sk, D)).astype(f),
            rng.standard_normal((1, h, sq, D)).astype(f))


def _pad_rows(x, n):
    """[BH, S, ...] padded with zero rows to a multiple of ``n``."""
    pad = [(0, 0), (0, (-x.shape[1]) % n)] + [(0, 0)] * (x.ndim - 2)
    return jnp.pad(x, pad)


def _jax_bwd(q, k, v, do, lse, delta, causal, dtype):
    """dq, dk, dv from the v1 Pallas kernels in interpret mode, given lse
    and delta (float32 [1, H, Sq])."""
    _, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    jd = jnp.dtype(dtype)
    flat = lambda x: _pad_rows(jnp.asarray(x, jd).reshape(-1, *x.shape[2:]),  # noqa
                               BLOCK)
    lanes = lambda x: jnp.broadcast_to(  # noqa: E731
        _pad_rows(jnp.asarray(x).reshape(h, sq), BLOCK)[..., None],
        (h, sq + (-sq) % BLOCK, 128))
    kw = dict(sm_scale=1.0 / math.sqrt(D), causal=causal, block_q=BLOCK,
              block_k=BLOCK, kv_len=sk, interpret=True, head_rep=h // hkv)
    args = (flat(q), flat(k), flat(v), flat(do), lanes(lse), lanes(delta))
    dq = jfa._bwd_dq_call(*args, **kw)
    dk, dv = jfa._bwd_dkv_call(*args, **kw)
    return (np.asarray(dq.astype(jnp.float32))[:, :sq].reshape(q.shape),
            np.asarray(dk.astype(jnp.float32))[:, :sk].reshape(k.shape),
            np.asarray(dv.astype(jnp.float32))[:, :sk].reshape(v.shape))


def _jax_fwd(q, k, v, causal):
    """o and natural-log lse of the v1 forward kernel in interpret mode."""
    _, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    flat = lambda x: _pad_rows(jnp.asarray(x).reshape(-1, *x.shape[2:]),  # noqa
                               BLOCK)
    o, lse = jfa._fwd(flat(q), flat(k), flat(v), 1.0 / math.sqrt(D), causal,
                      BLOCK, BLOCK, True, sk, h // hkv)
    return (np.asarray(o)[:, :sq].reshape(q.shape),
            np.asarray(lse)[:, :sq].reshape(1, h, sq))


@pytest.mark.parametrize("causal,h,hkv,sq,sk,dtype", CASES)
def test_tiled_backward_models_match_the_jax_kernels(causal, h, hkv, sq, sk,
                                                     dtype):
    q, k, v, do = _inputs(sq + 7 * h + hkv, h, hkv, sq, sk)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    # lse and delta from float32 inputs: the ring callers hand both kernels
    # the same given values, so both sides start from the same numbers
    o, lse = tfa.flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                           causal)
    want_o, want_lse = _jax_fwd(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), want_o, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **FWD_TOL)
    delta = (torch.from_numpy(do) * o).sum(-1)

    dq = tfa.flash_attention_bwd_dq_tiled_plain(tq, tk, tv, tdo, lse, delta,
                                                causal)
    dk, dv = tfa.flash_attention_bwd_dkv_tiled_plain(tq, tk, tv, tdo, lse,
                                                     delta, causal)
    assert (dq.dtype, dk.dtype, dv.dtype) == (tdt, tdt, tdt)
    # JAX gets the port's bf16-rounded inputs, so both start from one tensor
    rounded = [x.float().numpy() for x in (tq, tk, tv, tdo)]
    want = _jax_bwd(*rounded, lse.numpy(), delta.numpy(), causal, dtype)
    for label, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL,
                                       err_msg=label)
        else:
            chip_smoke.flash_compare(label, got, torch.tensor(ref),
                                     torch.bfloat16, None)


@pytest.mark.parametrize("causal", [True, False])
def test_tiled_models_equal_the_plain_backward_in_float64(causal):
    """The tiling and the exp2 domain change nothing but rounding."""
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)) for s in
                   ((2, 6, 200, D), (2, 2, 200, D), (2, 2, 200, D),
                    (2, 6, 200, D)))
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    delta = tfa._delta(o, do)
    dq = tfa.flash_attention_bwd_dq_tiled_plain(q, k, v, do, lse, delta,
                                                causal)
    dk, dv = tfa.flash_attention_bwd_dkv_tiled_plain(q, k, v, do, lse, delta,
                                                     causal)
    want_dq = tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                               causal)
    want_dk, want_dv = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta, causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def test_bwd_route_picks_wgmma_for_bf16_and_tiles_for_f32():
    # float16 takes the wgmma kernels too (instantiated for __half)
    assert tfa.bwd_route(torch.bfloat16) == "wgmma"
    assert tfa.bwd_route(torch.float16) == "wgmma"
    assert tfa.bwd_route(torch.float32) == "tile"
    for dtype in (torch.float64, torch.int8):
        with pytest.raises(ValueError, match="not supported"):
            tfa.bwd_route(dtype)


def test_cpu_backward_wrappers_stay_plain_and_uncounted():
    tfa.reset_launch_counts()
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(torch.bfloat16) for s in
                   ((1, 4, 70, D), (1, 2, 70, D), (1, 2, 70, D),
                    (1, 4, 70, D)))
    o, lse = tfa.flash_attention_fwd_cuda(q, k, v)
    dq, delta = tfa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o)
    dk, dv = tfa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    assert torch.equal(delta, tfa._delta(o, do))
    assert torch.equal(dq, tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse,
                                                             delta))
    want_dk, want_dv = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    assert [fn.launches for fn in tfa.KERNELS] == [0, 0, 0]
