"""GPT-2's training options in the PyTorch port against the JAX package on
the CPU: activation checkpointing and its policies (``runtime/remat.py``),
the fused CE head and attention dropout on JAX's threefry keys.

The same JAX-initialised weights and numpy batches go through both
packages, in float32.  Tolerances: remat recomputes the same float32
operations, so the port with and without remat agrees within 1e-6 (atol
and rtol); against JAX, whose XLA graph sums in other orders, the loss is
held within 1e-5 and the gradients within 1e-4, as
``tests/test_torch_train.py`` holds the plain model.  Dropout masks are
compared bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import remat as jremat
from deepspeed_tpu.runtime.config import (ActivationCheckpointingConfig as
                                          JACConfig)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import sampling
from deepspeed_tpu_torch.runtime import remat as tremat
from deepspeed_tpu_torch.runtime.config import (ActivationCheckpointingConfig
                                                as TACConfig)

torch.set_num_threads(1)

EXACT = dict(atol=1e-6, rtol=1e-6)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    cfg = jgpt2.GPT2Config.tiny()
    jparams = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(3)))
    return cfg, tgpt2.GPT2Config.tiny(), jparams


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _port_loss_and_grads(tcfg, jparams, batch, rng=None):
    params = jax.tree_util.tree_map(lambda x: x.requires_grad_(),
                                    tgpt2.params_from_jax(jparams))
    loss = tgpt2.loss_from_batch(tcfg, params, batch, rng)
    loss.backward()
    return loss.item(), jax.tree_util.tree_map(lambda t: t.grad, params)


def _assert_grads(got, want, **tol):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(_leaf(got, path).detach().numpy(),
                                   np.asarray(leaf),
                                   err_msg=str(path), **tol)


# -------------------------------------------------------------------- remat
#: (label, remat_policy, remat_offload, use_flash)
REMAT_CASES = [("full", "full", False, True), ("dots", "dots", False, True),
               ("dots_flash", "dots_flash", False, True),
               ("dots+offload", "dots", True, True),
               ("dots einsum", "dots", False, False)]


@pytest.mark.parametrize("label,policy,offload,use_flash", REMAT_CASES,
                         ids=[c[0] for c in REMAT_CASES])
def test_remat_policies_match_no_remat_and_jax(tiny, label, policy, offload,
                                               use_flash):
    """Loss and grads with each policy equal the port without remat within
    1e-6 and JAX's remat (``jax.checkpoint`` with the same policy, its
    flash kernel in interpret mode) within 1e-5 / 1e-4; the policy saves
    what it names (the offloaded bytes: the four projections a layer, and
    under dots_flash o and lse too) and dots_flash runs the forward kernel
    once a layer."""
    cfg, tcfg, jparams = tiny
    kw = dict(use_flash=use_flash)
    rkw = dict(kw, remat=True, remat_policy=policy, remat_offload=offload)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, 21)).astype(np.int32)
    jbatch = {"input_ids": jnp.asarray(ids)}
    tbatch = {"input_ids": torch.from_numpy(ids).long()}
    jcfg = dataclasses.replace(cfg, **rkw)
    want, want_g = jax.value_and_grad(
        lambda p: jgpt2.loss_from_batch(jcfg, p, jbatch))(jparams)
    plain, plain_g = _port_loss_and_grads(dataclasses.replace(tcfg, **kw),
                                          jparams, tbatch)
    calls = []
    fwd_plain = tfa.flash_attention_fwd_plain

    def counted(*a, **k):
        calls.append(1)
        return fwd_plain(*a, **k)

    tremat.OFFLOAD_STATS.update(bytes=0, tensors=0)
    tfa.flash_attention_fwd_plain = counted
    try:
        got, got_g = _port_loss_and_grads(dataclasses.replace(tcfg, **rkw),
                                          jparams, tbatch)
    finally:
        tfa.flash_attention_fwd_plain = fwd_plain
    np.testing.assert_allclose(got, plain, **EXACT)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a.numpy(), b.numpy(),
                                                **EXACT), got_g, plain_g)
    np.testing.assert_allclose(got, float(want), **LOSS_TOL)
    _assert_grads(got_g, want_g, **GRAD_TOL)
    layers, rows, d = tcfg.num_layers, 2 * 20, tcfg.hidden_size
    if use_flash:
        assert len(calls) == layers * (1 if policy == "dots_flash" else 2)
    if offload:
        # qkv, o, fc and proj outputs of every layer, float32
        assert tremat.OFFLOAD_STATS["bytes"] == layers * rows * (
            3 * d + d + 4 * d + d) * 4
        assert tremat.OFFLOAD_STATS["tensors"] == 4 * layers


AC_BLOCKS = [{}, {"enabled": True}, {"policy": "dots_flash"},
             {"partition_activations": True},
             {"cpu_checkpointing": True, "policy": "full"},
             {"number_checkpoints": 4, "policy": "dots"}]


@pytest.mark.parametrize("block", AC_BLOCKS, ids=range(len(AC_BLOCKS)))
def test_activation_checkpointing_block_maps_as_jax(block):
    """``apply_config_to_model`` switches the same knobs in both packages
    on one device, and returns the same answer."""
    jcfg, tcfg = jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()
    jmodel, tmodel = jgpt2.build(jcfg), tgpt2.build(tcfg)
    want = jremat.apply_config_to_model(JACConfig(**block), jmodel)
    got = tremat.apply_config_to_model(TACConfig(**block), tmodel)
    assert got == want
    for knob in ("remat", "remat_policy", "remat_offload"):
        assert getattr(tmodel.model_config, knob) == \
            getattr(jmodel.model_config, knob), knob


def test_engine_applies_activation_checkpointing(tiny):
    """``initialize`` with the block turns remat on, and the engine's step
    equals one without remat (fp32), as JAX's does."""
    cfg, tcfg, jparams = tiny
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 17))
    losses = []
    for block in (None, {"policy": "dots", "cpu_checkpointing": True}):
        conf = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
                **({"activation_checkpointing": block} if block else {})}
        model = tgpt2.build(dataclasses.replace(tcfg))
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=conf, device="cpu",
            model_parameters=tgpt2.params_from_jax(jparams))
        assert model.model_config.remat == (block is not None)
        losses.append([eng.train_batch({"input_ids": ids})[1]["loss"]
                       for _ in range(2)])
    np.testing.assert_allclose(losses[1], losses[0], **EXACT)


def test_unknown_policy_raises_in_both():
    with pytest.raises(ValueError, match="unknown remat policy"):
        jremat.remat_policy("everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        tremat.check_policy("everything")


# ----------------------------------------------------------------- fused CE
@pytest.mark.parametrize("rows,ce_chunks", [(13, 4), (13, 5), (16, 4)])
def test_fused_ce_head_matches_jax(tiny, rows, ce_chunks):
    """``_head_loss_fused`` (final LN + the chunked tied-head CE) with -100
    labels, at row counts ``ce_chunks`` does not divide (2 x 13 rows: 4 and
    5 step down to 2), against JAX's: loss within 1e-5, the grads of wte,
    the final LN and x within 1e-4."""
    cfg, tcfg, jparams = tiny
    cfg = dataclasses.replace(cfg, ce_chunks=ce_chunks)
    tcfg = dataclasses.replace(tcfg, ce_chunks=ce_chunks, fused_ce=True)
    rng = np.random.default_rng(rows + ce_chunks)
    x = rng.standard_normal((2, rows, cfg.hidden_size)).astype(np.float32)
    lab = rng.integers(0, cfg.vocab_size, (2, rows)).astype(np.int32)
    lab[0, :3] = -100
    lab[1, -2:] = -100
    head = {k: jparams[k] for k in ("wte", "lnf_scale", "lnf_bias")}
    want, (want_p, want_x) = jax.value_and_grad(
        lambda p, x: jgpt2._head_loss_fused(cfg, p, x, jnp.asarray(lab)),
        argnums=(0, 1))(head, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in head.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got = tgpt2._head_loss_fused(tcfg, tp, tx, torch.from_numpy(lab).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x),
                               **GRAD_TOL)
    for k in head:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_p[k]),
                                   err_msg=k, **GRAD_TOL)


def test_fused_ce_model_loss_matches_jax_and_plain_head(tiny):
    """``loss_from_batch`` with ``fused_ce``: JAX's within 1e-5 / 1e-4, and
    the port's own unfused head within 1e-6 (both float32)."""
    cfg, tcfg, jparams = tiny
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                            (3, 18)).astype(np.int32)
    jcfg = dataclasses.replace(cfg, fused_ce=True)
    want, want_g = jax.value_and_grad(lambda p: jgpt2.loss_from_batch(
        jcfg, p, {"input_ids": jnp.asarray(ids)}))(jparams)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    got, got_g = _port_loss_and_grads(dataclasses.replace(tcfg, fused_ce=True),
                                      jparams, batch)
    plain, plain_g = _port_loss_and_grads(tcfg, jparams, batch)
    np.testing.assert_allclose(got, float(want), **LOSS_TOL)
    _assert_grads(got_g, want_g, **GRAD_TOL)
    np.testing.assert_allclose(got, plain, **EXACT)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a.numpy(), b.numpy(),
                                                atol=1e-6, rtol=1e-5),
        got_g, plain_g)


# ------------------------------------------------------------------ dropout
@pytest.mark.parametrize("seed,step,micro,layer", [(42, 0, 0, 0),
                                                   (7, 3, 1, 1),
                                                   (123, 11, 0, 5)])
def test_dropout_masks_match_jax_bit_for_bit(seed, step, micro, layer):
    """The keep mask of (seed, step, micro-step, layer): the engine's key
    chain ``fold_in(fold_in(fold_in(PRNGKey(seed + 1), step), micro),
    layer)`` and ``jax.random.bernoulli(key, 1 - p, shape)``."""
    shape, p = (2, 4, 24, 24), 0.1
    jkey = jax.random.PRNGKey(seed + 1)
    for d in (step, micro, layer):
        jkey = jax.random.fold_in(jkey, d)
    want = np.asarray(jax.random.bernoulli(jkey, 1.0 - p, shape))
    tkey = sampling.PRNGKey(seed + 1)
    for d in (step, micro, layer):
        tkey = sampling.fold_in(tkey, d)
    np.testing.assert_array_equal(tkey.numpy(),
                                  np.asarray(jax.random.key_data(jkey)
                                             if hasattr(jkey, "dtype") and
                                             jnp.issubdtype(jkey.dtype,
                                                            jax.dtypes.prng_key)
                                             else jkey).astype(np.int64))
    got = tgpt2.dropout_keep(tkey, shape, p).numpy()
    np.testing.assert_array_equal(got, want)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tgpt2.GPT2Config.tiny()), device="cpu",
        config={"train_batch_size": 2, "seed": seed})
    np.testing.assert_array_equal(
        sampling.fold_in(eng._micro_rng(micro, step), layer).numpy(),
        tkey.numpy())


def test_dropout_trajectory_matches_jax(tiny):
    """``dropout=0.1``: 3 GAS-2 steps of both engines from the same weights
    (fp32, einsum attention, the keys of step and micro-step): losses
    within 1e-5, weights within 1e-4; ``eval_batch`` drops nothing."""
    cfg, tcfg, _ = tiny
    cfg = dataclasses.replace(cfg, dropout=0.1)
    tcfg = dataclasses.replace(tcfg, dropout=0.1)
    conf = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "seed": 5,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 0.5, "steps_per_print": 100}
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=jgpt2.build(cfg), config=conf)
    start = jax.device_get(jeng.state["params"])
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), config=conf, device="cpu",
        model_parameters=tgpt2.params_from_jax(start))
    rng = np.random.default_rng(4)
    for _ in range(3):
        ids = rng.integers(0, cfg.vocab_size, (16, 25)).astype(np.int32)
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), **LOSS_TOL)
    _assert_grads(teng.params, jax.device_get(jeng.state["params"]),
                  **GRAD_TOL)
    ev = teng.eval_batch({"input_ids": ids})
    np.testing.assert_allclose(
        ev.item(), float(jeng.eval_batch({"input_ids": ids})), **LOSS_TOL)
    nodrop = tgpt2.loss_from_batch(
        tcfg, teng.params, {"input_ids": torch.from_numpy(ids).long()},
        train=False)
    np.testing.assert_allclose(ev.item(), nodrop.item(), **EXACT)
