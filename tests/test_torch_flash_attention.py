"""The PyTorch port's flash attention (``deepspeed_tpu_torch/ops/
flash_attention.py``) against the JAX package's Pallas kernels, run in
interpret mode on the CPU as the JAX package's own tests run them.

On the CPU the port's kernel wrappers and its autograd op take the plain
versions, so every case holds the port's arithmetic against each TPU
dispatch regime in float32: o and lse at atol = rtol = 1e-5 and dq, dk, dv
at 1e-4 (the kernels sum in blocks, the plain versions in one pass).  The
regimes: v2 (kv_pad <= 1024, the GPT-2 path), v3 (forced with
``DS_FLASH_V2=0`` and ``DS_FLASH_V3_MIN_KV=64``, which the JAX dispatch
reads at every call) and v1 (the lse returned by ``_fwd``, and the dq / dkv
calls that take a given lse and delta).  The CUDA kernels are held against
the plain versions on the card by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, h, hkv, s, d=16, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    f = np.float32
    return (rng.standard_normal((b, h, s, d)).astype(f),
            rng.standard_normal((b, hkv, sk, d)).astype(f),
            rng.standard_normal((b, hkv, sk, d)).astype(f),
            rng.standard_normal((b, h, s, d)).astype(f))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _port_fwd_bwd(q, k, v, do, causal):
    """o and (dq, dk, dv) through the port's autograd op."""
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    o.backward(_t(do))
    return o.detach().numpy(), (tq.grad, tk.grad, tv.grad)


def _jax_fwd_bwd(q, k, v, do, causal, block):
    fn = lambda q, k, v: jfa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, block_q=block, block_k=block, interpret=True)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), vjp(jnp.asarray(do))


def _v1_fwd(q, k, v, causal, block):
    """The v1 kernel's o [B, H, S, D] and natural-log lse [B, H, S]
    (padding as ``flash_attention`` pads)."""
    b, h, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    pq, pk = (-s) % block, (-sk) % block
    qf = jnp.pad(jnp.asarray(q.reshape(b * h, s, d)), ((0, 0), (0, pq), (0, 0)))
    kf = jnp.pad(jnp.asarray(k.reshape(b * hkv, sk, d)),
                 ((0, 0), (0, pk), (0, 0)))
    vf = jnp.pad(jnp.asarray(v.reshape(b * hkv, sk, d)),
                 ((0, 0), (0, pk), (0, 0)))
    o, lse = jfa._fwd(qf, kf, vf, 1.0 / math.sqrt(d), causal, block, block,
                      True, sk, h // hkv)
    return (np.asarray(o)[:, :s].reshape(b, h, s, d),
            np.asarray(lse)[:, :s].reshape(b, h, s))


# (causal, H, Hkv, S): aligned and unaligned S, GQA rep=2, full attention
CASES = [(True, 4, 4, 64), (False, 4, 4, 64), (True, 4, 2, 72),
         (False, 4, 2, 50)]


@pytest.mark.parametrize("causal,h,hkv,s", CASES)
def test_forward_and_grads_match_v2_and_v1(causal, h, hkv, s):
    q, k, v, do = _inputs(s + h * hkv, 2, h, hkv, s)
    want_o, want_g = _jax_fwd_bwd(q, k, v, do, causal, block=32)
    got_o, got_g = _port_fwd_bwd(q, k, v, do, causal)
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    o, lse = tfa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal)
    v1_o, v1_lse = _v1_fwd(q, k, v, causal, 32)
    np.testing.assert_allclose(o.numpy(), want_o, **FWD_TOL)
    np.testing.assert_allclose(o.numpy(), v1_o, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), v1_lse, **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_128_matches_v2_and_v1(causal):
    """Llama's head dim 128 at GQA 8 / 2 and an unaligned S: the port's op
    against the JAX kernels (forward, lse and grads) as at D = 16."""
    q, k, v, do = _inputs(128 + causal, 1, 8, 2, 72, d=128)
    want_o, want_g = _jax_fwd_bwd(q, k, v, do, causal, block=32)
    got_o, got_g = _port_fwd_bwd(q, k, v, do, causal)
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    o, lse = tfa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal)
    v1_o, v1_lse = _v1_fwd(q, k, v, causal, 32)
    np.testing.assert_allclose(o.numpy(), v1_o, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), v1_lse, **FWD_TOL)


def test_the_kernels_take_head_dims_64_and_128():
    """The CUDA entry points' head dims: 64 and 128, the layout gate 64
    only (ROADMAP Queue B "still to port"); every other D raises before
    anything is launched."""
    for d in (64, 128):
        tfa.check_head_dim("fa", d)
    tfa.check_head_dim("fa", 64, gated=True)
    with pytest.raises(ValueError, match="layout gate at head dim 128"):
        tfa.check_head_dim("fa", 128, gated=True)
    for d in (16, 96, 256):
        for gated in (False, True):
            with pytest.raises(ValueError, match=f"head dim {d} not in"):
                tfa.check_head_dim("fa", d, gated)
    # on CPU tensors the CUDA checks pass the head dim and stop at the
    # device; D = 96 stops at the head dim
    for d, match in ((128, "must be a CUDA tensor"), (96, "head dim 96")):
        q, k, v, _ = map(_t, _inputs(2, 1, 2, 1, 8, d=d))
        with pytest.raises(ValueError, match=match):
            tfa._check_cuda("fa", q, k, v)
    with pytest.raises(ValueError, match="layout gate"):
        tfa._check_cuda("fa", *map(_t, _inputs(2, 1, 2, 1, 8, d=128)[:3]),
                        gated=True)


@pytest.mark.parametrize("causal,hkv", [(True, 2), (False, 4)])
def test_forward_and_grads_match_v3(monkeypatch, causal, hkv):
    """The long-sequence regime: chunked online softmax and exp2-domain
    compact lse, forced at a small kv_pad."""
    monkeypatch.setenv("DS_FLASH_V2", "0")
    monkeypatch.setenv("DS_FLASH_V3_MIN_KV", "64")
    q, k, v, do = _inputs(7 + hkv, 1, 4, hkv, 96)
    assert jfa._v3_eligible(96, 16) and not jfa._v2_eligible(96, 16)
    want_o, want_g = _jax_fwd_bwd(q, k, v, do, causal, block=32)
    got_o, got_g = _port_fwd_bwd(q, k, v, do, causal)
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_delta_taking_dq_and_dkv_match_v1_calls(causal):
    """The ring-attention building blocks: dq and dkv given lse and delta,
    against ``_bwd_dq_call`` / ``_bwd_dkv_call`` with the same lse and
    delta (GQA rep=2, unaligned S, a query chunk longer than the key
    chunk)."""
    b, h, hkv, s, sk, d = 1, 4, 2, 40, 24, 16
    q, k, v, do = _inputs(11, b, h, hkv, s, d, sk=sk)
    o, lse = tfa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal)
    dq_w, delta = tfa.flash_attention_bwd_dq_cuda(
        _t(q), _t(k), _t(v), _t(do), lse, o=o, causal=causal)
    np.testing.assert_allclose(delta.numpy(), (do * o.numpy()).sum(-1),
                               **FWD_TOL)
    dq, delta_back = tfa.flash_attention_bwd_dq_cuda(
        _t(q), _t(k), _t(v), _t(do), lse, delta, causal=causal)
    assert delta_back is delta
    torch.testing.assert_close(dq, dq_w, atol=0, rtol=0)
    dk, dv = tfa.flash_attention_bwd_dkv_cuda(_t(q), _t(k), _t(v), _t(do),
                                              lse, delta, causal=causal)

    blk = 8
    pad = lambda x, n: jnp.pad(jnp.asarray(x), ((0, 0), (0, n), (0, 0)))  # noqa
    lanes = lambda x: jnp.broadcast_to(x[..., None], x.shape + (128,))  # noqa
    qf = pad(q.reshape(b * h, s, d), (-s) % blk)
    dof = pad(do.reshape(b * h, s, d), (-s) % blk)
    kf = pad(k.reshape(b * hkv, sk, d), (-sk) % blk)
    vf = pad(v.reshape(b * hkv, sk, d), (-sk) % blk)
    lse_b = lanes(pad(lse.numpy().reshape(b * h, s, 1), (-s) % blk)[..., 0])
    del_b = lanes(pad(delta.numpy().reshape(b * h, s, 1), (-s) % blk)[..., 0])
    kw = dict(sm_scale=1.0 / math.sqrt(d), causal=causal, block_q=blk,
              block_k=blk, kv_len=sk, interpret=True, head_rep=h // hkv)
    want_dq = jfa._bwd_dq_call(qf, kf, vf, dof, lse_b, del_b, **kw)
    want_dk, want_dv = jfa._bwd_dkv_call(qf, kf, vf, dof, lse_b, del_b, **kw)
    np.testing.assert_allclose(
        dq.numpy(), np.asarray(want_dq)[:, :s].reshape(q.shape), **GRAD_TOL)
    np.testing.assert_allclose(
        dk.numpy(), np.asarray(want_dk)[:, :sk].reshape(k.shape), **GRAD_TOL)
    np.testing.assert_allclose(
        dv.numpy(), np.asarray(want_dv)[:, :sk].reshape(v.shape), **GRAD_TOL)


@pytest.mark.parametrize("causal,hkv", [(True, 1), (False, 2)])
def test_autograd_op_passes_gradcheck_in_float64(causal, hkv):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 6, 4))).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, hkv, 6, 4))).requires_grad_()
    v = torch.from_numpy(rng.standard_normal((1, hkv, 6, 4))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal),
        (q, k, v))


def test_mha_reference_and_backward_plain_match_jax():
    q, k, v, do = _inputs(3, 2, 4, 2, 24)
    for causal in (True, False):
        want = jfa.mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
        got = tfa.mha_reference(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
        _, vjp = jax.vjp(lambda q, k, v: jfa.mha_reference(q, k, v, causal),
                         *map(jnp.asarray, (q, k, v)))
        o, lse = tfa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal)
        grads = tfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse,
                                              _t(do), causal)
        for g, w in zip(grads, vjp(jnp.asarray(do))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    assert tfa.DEFAULT_MASK_VALUE == jfa.DEFAULT_MASK_VALUE


def test_cpu_calls_never_count_and_wrappers_check_their_arguments():
    tfa.reset_launch_counts()
    q, k, v, do = map(_t, _inputs(1, 1, 2, 2, 8))
    o, lse = tfa.flash_attention_fwd_cuda(q, k, v)
    tfa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                     tfa._delta(o, do))
    tfa.flash_attention(q, k, v).sum()
    assert [fn.launches for fn in tfa.KERNELS] == [0, 0, 0]
    with pytest.raises(ValueError, match="delta or o"):
        tfa.flash_attention_bwd_dq_cuda(q, k, v, do, lse)
    # the block-sparse gate: a float layout, or one without its block, is
    # refused; a one-block all-ones layout is the dense mask
    with pytest.raises(ValueError, match="integer or bool"):
        tfa.flash_attention_fwd_cuda(q, k, v, layout=torch.ones(2, 1, 1))
    lay = torch.ones(2, 1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="block"):
        tfa.flash_attention_fwd_cuda(q, k, v, layout=lay)
    o, lse = tfa.flash_attention_fwd_cuda(q, k, v, layout=lay, block=8)
    want_o, want_lse = tfa.flash_attention_fwd_plain(q, k, v)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert [fn.launches + fn.layout_launches for fn in tfa.KERNELS] == \
        [0, 0, 0]
