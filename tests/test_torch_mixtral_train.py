"""Mixtral training in the PyTorch port (``models/mixtral.py`` through
``initialize`` -> ``train_batch``, the MoE gating under autograd) against
the JAX package on the CPU, at fp32.

 - ``loss_from_batch`` of a tiny Mixtral at ``capacity_factor`` 1.25 (the
   batch drops choices past capacity): the loss within 1e-5 and every
   gradient within 1e-4 of ``jax.value_and_grad``'s (JAX's einsum
   attention), the port with remat and the flash op (its plain versions
   here) and without;
 - the engine's 3-step trajectory at ZeRO stage 0, stage 2 and stage 2
   with ``offload_optimizer: cpu``, each against the JAX engine at the
   same config, rtol 2e-4 as ``tests/test_torch_train.py`` holds llama's;
 - ``noisy_gate_policy="RSample"``: ``top1gating`` and ``moe_apply(k=1,
   train=True, rng=key)`` with the same JAX key give the masks and
   dispatch exactly and ``combine`` and the aux loss within 1e-6 (the
   Gumbel noise is the port's threefry, JAX's bits); ``train=False``
   ignores the key in both; the layer's gradients, noise or not, within
   1e-4 of JAX's;
 - ``drop_tokens=False`` refused by both.

``tests/conftest.py`` gives JAX 8 CPU devices, so both engines get the
same ``train_batch_size`` and GAS (JAX splits each micro-batch over dp=8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import mixtral as jmix
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import mixtral as tmix
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from deepspeed_tpu_torch.ops import cpu_adam

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """One OpenMP thread for the host Adam of the offloaded engines (the
    pool is the process's, shared with the JAX package's library)."""
    cpu_adam.set_num_threads(1)
    yield


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _assert_tree_close(got, want, **tol):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = _leaf(got, path)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(leaf), err_msg=str(path),
                                   **tol)


def _recorded_top2(monkeypatch):
    """Record the expert counts of every top-2 gating call of the port."""
    counts = []
    real = tlayer.top2gating

    def record(logits, *args):
        out = real(logits, *args)
        counts.append((logits.shape[0] * logits.shape[1],
                       int(out[3].sum())))
        return out
    monkeypatch.setattr(tlayer, "top2gating", record)
    return counts


# ----------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """The JAX reference once for both port routes: einsum attention, no
    remat (``jax.checkpoint`` recomputes the same values)."""
    cfg = dataclasses.replace(jmix.MixtralConfig.tiny(), use_flash=False)
    jparams = jax.device_get(jmix.init_params(cfg, jax.random.PRNGKey(3)))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 18)) \
        .astype(np.int32)
    want, want_g = jax.value_and_grad(lambda p: jmix.loss_from_batch(
        cfg, p, {"input_ids": jnp.asarray(ids)}))(jparams)
    return cfg, jparams, ids, float(want), want_g


@pytest.mark.parametrize("remat,use_flash", [(True, True), (False, False)])
def test_loss_and_grads_match_jax(monkeypatch, jax_loss_and_grads, remat,
                                  use_flash):
    """Capacity 1.25 of 17 tokens over 4 experts, top-2 (11 slots an
    expert): some choices drop, and the loss and gradients still match;
    with remat the recomputed blocks route as the first pass did."""
    cfg, jparams, ids, want, want_g = jax_loss_and_grads
    tcfg = dataclasses.replace(tmix.MixtralConfig.tiny(), remat=remat,
                               use_flash=use_flash)
    assert cfg.capacity_factor == tcfg.capacity_factor == 1.25
    counts = _recorded_top2(monkeypatch)
    tparams = jax.tree_util.tree_map(lambda x: x.requires_grad_(),
                                     tmix.params_from_jax(jparams))
    got = tmix.loss_from_batch(tcfg, tparams,
                               {"input_ids": torch.from_numpy(ids).long()})
    got.backward()
    np.testing.assert_allclose(got.item(), want, atol=1e-5, rtol=1e-5)
    grads = jax.tree_util.tree_map(lambda t: t.grad, tparams)
    _assert_tree_close(grads, want_g, atol=1e-4, rtol=1e-4)
    # every layer's gating ran (twice a layer under remat) and dropped
    assert len(counts) == cfg.num_layers * (2 if remat else 1)
    assert any(kept < 2 * tokens for tokens, kept in counts)
    assert tmix.build(tcfg).flops_per_token == \
        6.0 * cfg.num_params() / cfg.num_experts * (cfg.top_k + 1)


# ------------------------------------------------------------------- engine
def _engine_config(stage, offload):
    zero = {"stage": stage}
    if offload:
        zero["offload_optimizer"] = {"device": "cpu"}
    return {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 1e-4,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 3,
                                     "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "steps_per_print": 100,
            "zero_optimization": zero}


@pytest.mark.parametrize("stage,offload", [(0, False), (2, False),
                                           (2, True)])
def test_engine_trajectory_matches_jax(stage, offload):
    """A tiny Mixtral (remat, the flash op) through both engines from the
    same JAX weights: AdamW + WarmupLR + clipping, GAS 2, 3 steps."""
    cfg = jmix.MixtralConfig.tiny()
    tcfg = dataclasses.replace(tmix.MixtralConfig.tiny(), remat=True,
                               use_flash=True)
    conf = _engine_config(stage, offload)
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=jmix.build(cfg), config=conf)
    start = jax.device_get(jeng.state["params"])
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tmix.build(tcfg), config=conf,
        model_parameters=tmix.params_from_jax(start), device="cpu")
    assert teng.zero_optimization_stage() == stage
    assert teng.offload_enabled == offload
    rng = np.random.default_rng(8)
    for _ in range(3):
        ids = rng.integers(0, cfg.vocab_size, (16, 25)).astype(np.int32)
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-4)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-4)
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    _assert_tree_close(teng.params, jax.device_get(jeng.state["params"]),
                       rtol=2e-4, atol=2e-5)
    assert teng.global_steps == 3 and teng.micro_steps == 6
    teng.close()


# --------------------------------------------------------------- RSample
def _gate_both(logits, key, **kw):
    want = [np.asarray(a) for a in jmoe.top1gating(
        jnp.asarray(logits), 1.0, 2, rng=key, **kw)]
    got = [a.numpy() for a in tmoe.top1gating(
        torch.from_numpy(logits), 1.0, 2, rng=np.asarray(key), **kw)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    return got


@pytest.mark.parametrize("seed", [7, 11])
def test_rsample_top1gating_matches_jax(seed):
    """The same key gives the same Gumbel draw, so the same selection:
    masks and dispatch exact; the gates stay the clean softmax."""
    logits = np.random.default_rng(seed).standard_normal((3, 24, 6)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(seed)
    noisy = _gate_both(logits, key, noisy_gate_policy="RSample")
    clean = _gate_both(logits, key)
    # the noise moved some tokens, and the capacity dropped some
    assert not np.array_equal(noisy[2], clean[2])
    assert noisy[3].sum() < 3 * 24
    # a port key tensor works as the JAX array does
    again = tmoe.top1gating(torch.from_numpy(logits), 1.0, 2,
                            noisy_gate_policy="RSample",
                            rng=torch.tensor(np.asarray(key).astype(np.int64)))
    np.testing.assert_array_equal(again[2].numpy(), noisy[2])


def _moe_params(activation, e, d, f, seed):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    p = {"gate_w": n(d, e)}
    if activation == "silu_glu":
        p["experts"] = {"w1": n(e, d, f), "w2": n(e, f, d), "w3": n(e, d, f)}
    else:
        p["experts"] = {"fc_w": n(e, d, f), "fc_b": n(e, f),
                        "proj_w": n(e, f, d), "proj_b": n(e, d)}
    return p


def _moe_both(jcfg, tcfg, p, x, key, train):
    jy, jaux = jlayer.moe_apply(jcfg, p, jnp.asarray(x), rng=key,
                                train=train)
    ty, taux = tlayer.moe_apply(tcfg, tgpt2.params_from_jax(p),
                                torch.from_numpy(x), rng=np.asarray(key),
                                train=train)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    return ty, taux


def test_rsample_moe_apply_matches_jax():
    """``moe_apply(k=1)`` with the RSample policy: at ``train=True`` the
    key's noise routes both layers alike; at ``train=False`` both ignore
    it (the clean route)."""
    e, d, f = 4, 16, 32
    kw = dict(hidden_size=d, ffn_hidden_size=f, num_experts=e, k=1,
              capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=2,
              noisy_gate_policy="RSample", activation="gelu")
    jcfg, tcfg = jlayer.MoEConfig(**kw), tlayer.MoEConfig(**kw)
    p = _moe_params("gelu", e, d, f, 5)
    x = np.random.default_rng(6).standard_normal((2, 12, d)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(4)
    noisy, _ = _moe_both(jcfg, tcfg, p, x, key, True)
    clean_cfg = dataclasses.replace(tcfg, noisy_gate_policy=None)
    clean, _ = tlayer.moe_apply(clean_cfg, tgpt2.params_from_jax(p),
                                torch.from_numpy(x), train=True)
    assert not torch.equal(noisy, clean)
    evaluated, _ = _moe_both(jcfg, tcfg, p, x, key, False)
    unkeyed, _ = tlayer.moe_apply(tcfg, tgpt2.params_from_jax(p),
                                  torch.from_numpy(x), train=False)
    assert torch.equal(evaluated, unkeyed)


@pytest.mark.parametrize("k,policy,activation", [
    (1, "RSample", "gelu"), (1, None, "silu_glu"), (2, None, "silu_glu")])
def test_moe_apply_grads_match_jax(k, policy, activation):
    """The gradient of ``sum(y * w) + l_aux`` reaches the router through
    the combine weights and the aux loss, and the experts through their
    products, as in JAX (capacity 1.0 drops tokens)."""
    e, d, f = 4, 16, 24
    kw = dict(hidden_size=d, ffn_hidden_size=f, num_experts=e, k=k,
              capacity_factor=1.0, min_capacity=2, noisy_gate_policy=policy,
              activation=activation)
    jcfg, tcfg = jlayer.MoEConfig(**kw), tlayer.MoEConfig(**kw)
    p = _moe_params(activation, e, d, f, 9)
    x = np.random.default_rng(10).standard_normal((2, 10, d)) \
        .astype(np.float32)
    w = np.random.default_rng(11).standard_normal((2, 10, d)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(12)

    def jloss(params, xs):
        y, aux = jlayer.moe_apply(jcfg, params, xs, rng=key, train=True)
        return (y * w).sum() + aux

    want, (want_p, want_x) = jax.value_and_grad(jloss, argnums=(0, 1))(
        p, jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(),
                                tgpt2.params_from_jax(p))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tlayer.moe_apply(tcfg, tp, tx, rng=np.asarray(key), train=True)
    got = (y * torch.from_numpy(w)).sum() + aux
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x),
                               atol=1e-4, rtol=1e-4)
    _assert_tree_close(jax.tree_util.tree_map(lambda t: t.grad, tp), want_p,
                       atol=1e-4, rtol=1e-4)
    assert float(np.abs(tp["gate_w"].grad.numpy()).max()) > 0


def test_drop_tokens_false_is_refused_by_both():
    logits = np.zeros((1, 4, 4), np.float32)
    with pytest.raises(NotImplementedError, match="dynamic capacity"):
        jmoe.top1gating(jnp.asarray(logits), drop_tokens=False)
    with pytest.raises(NotImplementedError, match="dynamic capacity"):
        tmoe.top1gating(torch.from_numpy(logits), drop_tokens=False)
