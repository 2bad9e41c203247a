"""The PyTorch port's MoE (``deepspeed_tpu_torch/moe``) against the JAX
package's (``deepspeed_tpu/moe``), on the CPU at fp32.

 - ``top1gating`` / ``top2gating``: dispatch masks and expert counts equal,
   combine weights and the aux loss within 1e-6, on random logits whose
   capacity drops tokens, on forced argmax ties, and on a group built so a
   token's second choice drops (it keeps weight 1 on its first);
 - ``moe_apply`` within 1e-5 for top-1 and top-2, SwiGLU and GELU experts,
   and K-grouped int8 (w8a8) expert records dequantized at the point of
   use; the port's fixed row blocks change nothing;
 - ``dequantize_k`` on records with two leading dims, RSample gating
   running and ``drop_tokens=False`` refused.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)


def _gate_both(fn, logits, *args):
    want = [np.asarray(a) for a in getattr(jmoe, fn)(jnp.asarray(logits),
                                                      *args)]
    got = [a.numpy() for a in getattr(tmoe, fn)(torch.from_numpy(logits),
                                                 *args)]
    l_aux, combine, dispatch, counts = got
    np.testing.assert_allclose(l_aux, want[0], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(combine, want[1], atol=1e-6, rtol=1e-6)
    assert dispatch.dtype == np.bool_
    np.testing.assert_array_equal(dispatch, want[2])
    np.testing.assert_array_equal(counts, want[3])
    return got


@pytest.mark.parametrize("fn,cf", [("top1gating", 1.0), ("top1gating", 0.5),
                                   ("top2gating", 1.0), ("top2gating", 0.5)])
def test_gating_matches_jax_with_drops(fn, cf):
    logits = np.random.default_rng(0).standard_normal((3, 24, 6)) \
        .astype(np.float32)
    _, combine, dispatch, counts = _gate_both(fn, logits, cf, 2)
    k = 1 if fn == "top1gating" else 2
    # the capacity dropped some choices of some tokens
    assert counts.sum() < 3 * 24 * k
    assert dispatch.shape[-1] == tmoe._capacity(24, 6, k * cf, 2)


@pytest.mark.parametrize("fn", ["top1gating", "top2gating"])
def test_gating_ties_take_the_first_index(fn):
    """Rows of equal logits (every expert tied, and the top two tied):
    both packages route to the lowest index."""
    logits = np.zeros((1, 6, 4), np.float32)
    logits[0, 3] = [0.5, 2.0, 2.0, 0.1]
    logits[0, 4] = [1.0, 1.0, 0.2, 1.0]
    logits[0, 5] = [0.3, 0.9, 0.3, 0.3]
    _, combine, _, _ = _gate_both(fn, logits, 4.0, 4)
    first = combine.sum(-1).argmax(-1)[0]           # [S] expert of most weight
    assert first[0] == 0 and first[3] == 1 and first[4] == 0


def test_top2_second_choice_drop_renormalises_to_the_first():
    """Capacity 2 in one group of 4 tokens over 4 experts: expert 0 is
    everyone's second choice after two tokens claimed it first, so the
    second choices of the tokens preferring 1 and 2 drop; those keep
    weight 1 on their first expert."""
    logits = np.array([[[3.0, 1.0, 0.0, -1.0],
                        [3.0, 1.0, 0.0, -1.0],
                        [2.0, 3.0, 0.0, -1.0],
                        [2.0, 0.0, 3.0, -1.0]]], np.float32)
    _, combine, dispatch, counts = _gate_both("top2gating", logits, 0.5, 2)
    assert dispatch.shape[-1] == 2
    per_token = combine.sum(-1)[0]                  # [S, E]
    np.testing.assert_allclose(per_token[2], [0, 1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(per_token[3], [0, 0, 1, 0], atol=1e-6)
    assert counts.tolist() == [2, 2, 1, 0]


def _moe_params(activation, e, d, f, seed):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    p = {"gate_w": n(d, e)}
    if activation == "silu_glu":
        p["experts"] = {"w1": n(e, d, f), "w2": n(e, f, d), "w3": n(e, d, f)}
    else:
        p["experts"] = {"fc_w": n(e, d, f), "fc_b": n(e, f),
                        "proj_w": n(e, f, d), "proj_b": n(e, d)}
    return p


def _cfgs(**kw):
    return jlayer.MoEConfig(**kw), tlayer.MoEConfig(**kw)


@pytest.mark.parametrize("k,activation,shape", [
    (1, "gelu", (3, 16)), (2, "gelu", (2, 3, 16)), (2, "silu_glu", (2, 16)),
    (1, "silu_glu", (16,))])
def test_moe_apply_matches_jax(k, activation, shape):
    """Groups from the leading dims (a 2-D input is one group); capacity
    factor 1 drops tokens; train picks capacity_factor, eval the other."""
    e, d, f = 4, 32, 48
    jcfg, tcfg = _cfgs(hidden_size=d, ffn_hidden_size=f, num_experts=e, k=k,
                       capacity_factor=1.0, eval_capacity_factor=2.0,
                       min_capacity=2, activation=activation)
    p = _moe_params(activation, e, d, f, 1)
    x = np.random.default_rng(2).standard_normal(shape + (d,)) \
        .astype(np.float32)
    tp = tgpt2.params_from_jax(p)
    for train in (True, False):
        jy, jaux = jlayer.moe_apply(jcfg, p, jnp.asarray(x), train=train)
        ty, taux = tlayer.moe_apply(tcfg, tp, torch.from_numpy(x),
                                    train=train)
        assert ty.shape == x.shape and ty.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
        # the same result on the fixed row counts of either mode
        for rows in ("prefill", "decode"):
            fixed, _ = tlayer.moe_apply(tcfg, tp, torch.from_numpy(x),
                                        train=train, rows=rows)
            torch.testing.assert_close(fixed, ty, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind", ["w8a8", "weight"])
def test_moe_apply_dequantizes_int8_expert_records_like_jax(kind):
    """Expert leaves as int8 records (the quantized serving lanes): each
    dequantized at the point of use, within 1e-5 of the JAX layer."""
    e, d, f = 4, 128, 256
    jcfg, tcfg = _cfgs(hidden_size=d, ffn_hidden_size=f, num_experts=e, k=2,
                       activation="silu_glu")
    p = _moe_params("silu_glu", e, d, f, 3)
    if kind == "w8a8":
        recs = {n: jq.quantize_k_grouped(jnp.asarray(w), 128)
                for n, w in p["experts"].items()}
    else:
        recs = {n: jq.quantize(jnp.asarray(w), 8, 128)
                for n, w in p["experts"].items()}
    p = {"gate_w": p["gate_w"],
         "experts": {n: {k: np.asarray(v) for k, v in r.items()}
                     for n, r in recs.items()}}
    x = np.random.default_rng(4).standard_normal((2, 12, d)) \
        .astype(np.float32)
    jy, _ = jlayer.moe_apply(jcfg, p, jnp.asarray(x), train=False)
    ty, _ = tlayer.moe_apply(tcfg, tgpt2.params_from_jax(p),
                             torch.from_numpy(x), train=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)


def test_dequantize_k_takes_two_leading_dims():
    """A stacked expert record ``[L, E, K, N]`` expands to the JAX
    package's bits in f32 and bf16 alike."""
    w = (0.05 * np.random.default_rng(5).standard_normal((2, 3, 256, 128))) \
        .astype(np.float32)
    jrec = jq.quantize_k_grouped(jnp.asarray(w), 128)
    trec = tq.quantize_k_grouped(torch.from_numpy(w), 128)
    for k in ("qk", "kscale"):
        np.testing.assert_array_equal(trec[k].numpy(), np.asarray(jrec[k]))
    np.testing.assert_array_equal(tq.dequantize_k(trec, torch.float32)
                                  .numpy(),
                                  np.asarray(jq.dequantize_k(jrec,
                                                             jnp.float32)))
    got = tq.dequantize_k(trec, torch.bfloat16)
    want = (trec["qk"].float().reshape(2, 3, 2, 128, 128) * trec["kscale"]) \
        .reshape(2, 3, 256, 128).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_training_options_are_refused():
    """RSample noisy gating runs (held against JAX in
    ``tests/test_torch_mixtral_train.py``); ``drop_tokens=False`` raises
    with JAX's reason, as the JAX function does."""
    logits = torch.zeros(1, 4, 4)
    _, combine, dispatch, _ = tmoe.top1gating(
        logits, noisy_gate_policy="RSample", rng=np.array([0, 5], np.uint32))
    assert combine.shape == dispatch.shape == (1, 4, 4, 4)
    with pytest.raises(NotImplementedError, match="dynamic capacity"):
        tmoe.top1gating(logits, drop_tokens=False)
    cfg = tlayer.MoEConfig(hidden_size=8, ffn_hidden_size=8, num_experts=2,
                           k=3)
    p = tlayer.init_moe_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="k=3"):
        tlayer.moe_apply(cfg, p, torch.zeros(1, 2, 8))


def test_capacity_and_one_hot():
    assert tmoe._capacity(5, 8, 4.0, 4) == jmoe._capacity(5, 8, 4.0, 4) == 4
    assert tmoe._capacity(128, 8, 4.0, 4) == 64
    assert tmoe._capacity(3, 8, 8.0, 1) == 3            # ceil, not floor
    idx = torch.tensor([[0, 3, 5]])
    np.testing.assert_array_equal(tmoe._one_hot(idx, 4).numpy(),
                                  np.asarray(jmoe._one_hot(jnp.asarray(
                                      idx.numpy()), 4)))
