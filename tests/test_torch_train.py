"""The PyTorch port's training slice (``deepspeed_tpu_torch.initialize`` ->
``DeepSpeedEngine.train_batch``) against the JAX package on the CPU.

The same JAX-initialised weights go through both packages
(``gpt2.params_from_jax`` / ``model_parameters``) and the same numpy
batches through both engines.  Tolerances, fp32: GPT-2 loss 1e-5 and grads
1e-4 (different summation orders over a few layers); Adam and clipping
1e-6 over 5 steps (the same arithmetic up to rounding); the 5-step engine
trajectory rtol 2e-4.  ``tests/conftest.py`` gives JAX 8 CPU devices, so the
JAX engine splits each micro-batch over dp=8 where the port runs it whole:
the same ``train_batch_size`` means the same global and micro batches.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig as TConfig,
                                                DeepSpeedConfigError)

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    cfg = jgpt2.GPT2Config.tiny()
    jparams = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(3)))
    return cfg, tgpt2.GPT2Config.tiny(), jparams


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


# ----------------------------------------------------------------- the model
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("labels", [False, True])
def test_loss_and_grads_match_jax(tiny, use_flash, labels):
    """``loss_from_batch`` (shifted targets, or explicit labels with -100
    entries) and its gradients; ``use_flash=True`` runs the port's plain
    flash version and the JAX Pallas kernel in interpret mode."""
    cfg, tcfg, jparams = tiny
    cfg = dataclasses.replace(cfg, use_flash=use_flash)
    tcfg = dataclasses.replace(tcfg, use_flash=use_flash)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
        lab[0, :5] = -100
        lab[1, -3:] = -100
        jbatch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(lab)}
        tbatch = {"input_ids": torch.from_numpy(ids).long(),
                  "labels": torch.from_numpy(lab).long()}
    else:
        jbatch = {"input_ids": jnp.asarray(ids)}
        tbatch = {"input_ids": torch.from_numpy(ids).long()}
    want, want_g = jax.value_and_grad(
        lambda p: jgpt2.loss_from_batch(cfg, p, jbatch))(jparams)
    tparams = jax.tree_util.tree_map(lambda x: x.requires_grad_(),
                                     tgpt2.params_from_jax(jparams))
    got = tgpt2.loss_from_batch(tcfg, tparams, tbatch)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    grads = jax.tree_util.tree_map(lambda t: t.grad, tparams)
    _assert_tree_close(grads, want_g, atol=1e-4, rtol=1e-4)
    assert tgpt2.build(tcfg).flops_per_token == 6.0 * cfg.num_params()


# ------------------------------------------------------- optimizer and clip
ADAM_CASES = [
    dict(),
    dict(weight_decay=0.1),                     # AdamW: decay on the update
    dict(weight_decay=0.1, adam_w_mode=False),  # Adam: decay on the grad
    dict(bias_correction=False, betas=(0.8, 0.99), eps=1e-6),
]


@pytest.mark.parametrize("kw", ADAM_CASES)
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("schedule", [False, True])
def test_fused_adam_and_clipping_match_optax(kw, clip, schedule):
    rng = np.random.default_rng(2)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    lr = (lambda step: 1e-2 * (step + 1)) if schedule else 1e-2
    tx = jopt.fused_adam(lr=lr, **kw)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)

    opt = topt.FusedAdam(lr=lr, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    st = opt.init(tp)
    for g in grads:
        tg = [torch.from_numpy(x.copy()) for x in g]
        norm = topt.clip_by_global_norm(tg, clip) if clip else None
        if clip:
            np.testing.assert_allclose(
                norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        opt.step(tp, tg, st)
    assert st.count == 5
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


# ------------------------------------------------------------- LR schedules
SCHEDULES = [
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-3,
                         lr_range_test_step_size=4,
                         lr_range_test_step_rate=0.5)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-3,
                         lr_range_test_step_size=4,
                         lr_range_test_staircase=True)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=5, decay_lr_rate=0.1)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=4, cycle_second_step_size=6,
                      decay_lr_rate=0.5, decay_step_size=3)),
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                      warmup_num_steps=8)),
    ("WarmupLR", dict(warmup_max_lr=1e-3, warmup_num_steps=8,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=15, warmup_max_lr=1e-3,
                           warmup_num_steps=5)),
    ("WarmupDecayLR", dict(total_num_steps=15, warmup_min_lr=1e-4,
                           warmup_max_lr=1e-3, warmup_num_steps=5,
                           warmup_type="linear")),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    """rtol 1e-5: the JAX schedules compute in float32 (a few roundings of
    6e-8 each), the port's in float64."""
    want = jlr.get_lr_schedule(name, params)
    got = tlr.get_lr_schedule(name, params)
    for step in range(20):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"{name} step {step}")
    sched = tlr.LRScheduler(got)
    sched.step(3)
    assert sched.get_lr() == [got(3)]


# ------------------------------------------------------------------- config
BATCH_CASES = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 8},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2},
    {"train_batch_size": 12},
    {"train_micro_batch_size_per_gpu": 6},
    {"gradient_accumulation_steps": 3},
    {"train_batch_size": "auto", "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": "auto",
     "zero_optimization": {"reduce_bucket_size": "auto"}},
]


@pytest.mark.parametrize("conf", BATCH_CASES)
def test_batch_triangle_and_auto_match_jax(conf):
    want, got = JConfig(dict(conf), world_size=1), TConfig(dict(conf))
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                "gradient_accumulation_steps", "gradient_clipping",
                "steps_per_print", "seed", "precision_dtype"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.zero_config.reduce_bucket_size == \
        want.zero_config.reduce_bucket_size


def test_inconsistent_batch_triple_raises_in_both():
    bad = {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2}
    with pytest.raises(AssertionError):
        JConfig(dict(bad), world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        TConfig(dict(bad))
    with pytest.raises(DeepSpeedConfigError):
        TConfig({})


# ------------------------------------------------------------------- engine
def _engine_config(gas):
    return {"train_batch_size": 16, "gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 1e-4,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 3,
                                     "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "steps_per_print": 100}


@pytest.mark.parametrize("gas", [1, 2])
def test_engine_trajectory_matches_jax(tiny, gas):
    cfg, tcfg, _ = tiny
    conf = _engine_config(gas)
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=jgpt2.build(cfg), config=conf)
    start = jax.device_get(jeng.state["params"])
    teng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), config=conf,
        model_parameters=tgpt2.params_from_jax(start), device="cpu")
    assert isinstance(opt, topt.FusedAdam) and loader is None
    assert (teng.train_micro_batch_size_per_gpu(),
            teng.gradient_accumulation_steps()) == (16 // gas, gas)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, cfg.vocab_size, (16, 33)).astype(np.int32)
               for _ in range(5)]
    for ids in batches:
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-4)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-4)
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    _assert_tree_close(teng.params, jax.device_get(jeng.state["params"]),
                       rtol=2e-4, atol=2e-5)
    assert teng.global_steps == 5 and teng.micro_steps == 5 * gas
    assert sched.get_lr() == teng.get_lr()


# -------------------------------------------------------------------- llama
@pytest.mark.parametrize("remat,use_flash", [(True, True), (False, False)])
def test_llama_engine_trajectory_matches_jax(remat, use_flash):
    """A tiny llama (GQA 4 / 2) through both engines from the same JAX
    weights, fp32, AdamW + WarmupLR + clipping, GAS 2, 3 steps: the card's
    route (remat, the flash op: its plain versions here, the JAX Pallas
    kernel in interpret mode) and plain attention without remat."""
    kw = dict(remat=remat, use_flash=use_flash)
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **kw)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), **kw)
    conf = _engine_config(2)
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=jllama.build(cfg), config=conf)
    start = jax.device_get(jeng.state["params"])
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.build(tcfg), config=conf,
        model_parameters=tllama.params_from_jax(start), device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(3):
        ids = rng.integers(0, cfg.vocab_size, (16, 25)).astype(np.int32)
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-4)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-4)
    _assert_tree_close(teng.params, jax.device_get(jeng.state["params"]),
                       rtol=2e-4, atol=2e-5)
    assert teng.global_steps == 3 and teng.micro_steps == 6


def test_llama_head_dim_128_loss_and_grads_match_jax():
    """Head dim 128 (hidden 256, 2 query heads over 1 KV head), remat and
    the flash op, against JAX's loss and grads (its Pallas kernel in
    interpret mode): the shapes Llama-3-8B gives the D = 128 kernels."""
    kw = dict(vocab_size=256, max_seq_len=64, num_layers=1, num_heads=2,
              num_kv_heads=1, hidden_size=256, ffn_size=512,
              rope_theta=500000.0, remat=True, use_flash=True)
    cfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    assert tcfg.head_dim == 128
    jparams = jax.device_get(jllama.init_params(cfg, jax.random.PRNGKey(4)))
    ids = np.random.default_rng(9).integers(0, 256, (2, 41)).astype(np.int32)
    want, want_g = jax.value_and_grad(lambda p: jllama.loss_from_batch(
        cfg, p, {"input_ids": jnp.asarray(ids)}))(jparams)
    tparams = jax.tree_util.tree_map(lambda x: x.requires_grad_(),
                                     tllama.params_from_jax(jparams))
    got = tllama.loss_from_batch(tcfg, tparams,
                                 {"input_ids": torch.from_numpy(ids).long()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    _assert_tree_close(jax.tree_util.tree_map(lambda t: t.grad, tparams),
                       want_g, atol=1e-4, rtol=1e-4)


def test_micro_step_shims_match_train_batch(tiny):
    """``forward`` / ``backward`` / ``step`` over the GAS micro-batches
    lands where one ``train_batch`` of the same rows lands."""
    cfg, tcfg, jparams = tiny
    conf = {**_engine_config(2), "wall_clock_breakdown": True}
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (16, 17))
    engines = [deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), config=conf, device="cpu",
        model_parameters=tgpt2.params_from_jax(jparams))[0] for _ in range(2)]
    engines[0].train_batch({"input_ids": ids})
    for half in (ids[:8], ids[8:]):
        loss = engines[1]({"input_ids": half})
        engines[1].backward(loss)
        engines[1].step()
    assert engines[1].global_steps == 1
    assert [engines[1].timers(n).count for n in ("fwd", "bwd", "step")] == \
        [2, 2, 1]
    for a, b in zip(engines[0]._leaves, engines[1]._leaves):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    loss = engines[0].eval_batch({"input_ids": ids})
    assert torch.isfinite(loss) and engines[0].global_steps == 1


def test_bf16_steps_are_finite_and_decrease(tiny):
    cfg, tcfg, jparams = tiny
    conf = {"train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "gradient_clipping": 1.0}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), config=conf, device="cpu",
        model_parameters=tgpt2.params_from_jax(jparams))
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (8, 25))
    losses = [eng.train_batch({"input_ids": ids})[1]["loss"]
              for _ in range(6)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(p.dtype == torch.float32 for p in eng._leaves)


def test_training_data_loader_feeds_train_batch(tiny):
    cfg, tcfg, jparams = tiny
    data = [{"input_ids": row} for row in np.random.default_rng(7).integers(
        0, cfg.vocab_size, (12, 9))]
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), training_data=data, device="cpu",
        config={"train_micro_batch_size_per_gpu": 4,
                "gradient_accumulation_steps": 2},
        model_parameters=tgpt2.params_from_jax(jparams))
    assert len(loader) == 3
    for _ in range(3):                    # wraps past the end of an epoch
        _, metrics = eng.train_batch()
        assert np.isfinite(metrics["loss"])


# ------------------------------------------------------- what is not ported
#: (fp16, activation_checkpointing, Adagrad and LAMB, once listed here, are
#: ported: tests/test_torch_fp16.py, test_torch_gpt2_train.py and
#: test_torch_optimizers.py hold them against the JAX engine)
UNPORTED = [
    {"optimizer": {"type": "OneBitLamb", "params": {}}},
    {"mesh": {"dp": 2}},
    {"zero_optimization": {"stage": 2}, "mesh": {"dp": 4}},
    {"wandb": {"enabled": True}},
    {"elasticity": {"enabled": True}},
    {"curriculum_learning": {"enabled": True}},
    {"data_efficiency": {"data_routing": {"random_ltd": {"enabled": True}}}},
    {"compression_training": {"weight_quantization": {}}},
    {"sparse_gradients": True},
    {"flops_profiler": {"enabled": True}},
    {"tensorboard": {"enabled": True}},
    {"pipeline": {"stages": 2}},
    {"optimizer": {"type": "OneBitAdam", "params": {}}},
    {"optimizer": {"type": "ZeroOneAdam", "params": {}}},
]


@pytest.mark.parametrize("extra", UNPORTED)
def test_unported_options_raise(tiny, extra):
    _, tcfg, _ = tiny
    conf = {"train_batch_size": 4, **extra}
    with pytest.raises(NotImplementedError):
        deepspeed_tpu_torch.initialize(model=tgpt2.build(tcfg), config=conf,
                                       device="cpu")


#: ZeRO stages and offload tiers the port runs at world size 1, as the JAX
#: package runs them on a one-device mesh
WORLD_SIZE_1 = [
    {"zero_optimization": {"stage": 1}},
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "nvme"}}},
    {"zero_optimization": {"stage": 3, "offload_optimizer": {
        "device": "cpu"}, "offload_param": {"device": "cpu"}}},
    {"optimizer": {"type": "Adagrad", "params": {"lr": 1e-2}},
     "zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
]


@pytest.mark.parametrize("extra", WORLD_SIZE_1)
def test_zero_and_offload_accepted_at_world_size_1(tiny, extra, tmp_path):
    """Each config builds an engine that trains a step (the offload tiers
    are held against the JAX package in ``test_torch_offload.py`` and
    ``test_torch_param_stream.py``)."""
    from deepspeed_tpu_torch.ops import cpu_adam

    cpu_adam.set_num_threads(1)     # one OpenMP thread a test worker
    _, tcfg, _ = tiny
    conf = {"train_batch_size": 2, **extra}
    off = conf["zero_optimization"].get("offload_optimizer")
    if off:
        off["nvme_path"] = str(tmp_path)
    eng, *_ = deepspeed_tpu_torch.initialize(model=tgpt2.build(tcfg),
                                             config=conf, device="cpu")
    assert eng.zero_optimization_stage() == conf["zero_optimization"].get(
        "stage", 0)
    assert eng.offload_enabled == bool(off)
    ids = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 9))
    _, metrics = eng.train_batch({"input_ids": ids})
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    eng.close()


def test_unported_model_options_checkpoints_and_devices(tiny):
    _, tcfg, _ = tiny
    # remat, fused_ce, dropout and SGD, once refused here, are ported
    for kw in ({"act_quant_bits": 8}, {"random_ltd_keep": 16},
               {"sp_impl": "ring"}):
        with pytest.raises(NotImplementedError):
            dataclasses.replace(tcfg, **kw)
    with pytest.raises(NotImplementedError):
        topt.get_optimizer("onebitadam", {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deepspeed_tpu_torch.initialize(model=tgpt2.build(tcfg),
                                           config={"train_batch_size": 2})


# ------------------------------------------------------- loader and timers
def test_dataloader_order_matches_jax():
    """Same seed, same shuffled micro-batches, epoch after epoch."""
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JLoader
    from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                        RepeatingLoader)

    data = [{"input_ids": np.full(3, i), "labels": (i, -i)} for i in range(10)]
    for drop_last in (True, False):
        want = JLoader(data, batch_size=4, seed=7, drop_last=drop_last)
        got = DeepSpeedDataLoader(data, batch_size=4, seed=7,
                                  drop_last=drop_last)
        assert len(got) == len(want)
        for _ in range(2):
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
                for a, b in zip(g["labels"], w["labels"]):
                    np.testing.assert_array_equal(a, b)
    it = RepeatingLoader(DeepSpeedDataLoader(data, batch_size=4, seed=0))
    assert len([next(it) for _ in range(5)]) == 5     # wraps past 2 batches


def test_timers_on_the_cpu():
    from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                                 ThroughputTimer)

    timers = SynchronizedWallClockTimer()
    for _ in range(3):
        timers("step").start()
        sum(range(1000))
        timers("step").stop()
    assert timers("step").count == 3 and timers("step").mean() > 0
    assert timers.get_mean(["step", "absent"]).keys() == {"step"}
    assert timers("step").elapsed(reset=True) > 0
    assert timers("step").count == 0
    logged = []
    tput = ThroughputTimer(batch_size=8, start_step=1, steps_per_output=2,
                           logging_fn=logged.append)
    for _ in range(4):
        tput.start()
        tput.stop(global_step=True, sync=True)
    assert tput.global_step_count == 4 and len(logged) == 2
    assert tput.avg_samples_per_sec() > 0
