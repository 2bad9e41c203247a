"""ZeRO-Offload and ZeRO-Infinity's optimizer tier in the port
(``deepspeed_tpu_torch/runtime/zero/offload.py`` and the offload path of
``runtime/engine.py``) against the JAX package on the CPU.

``HostOffloadOptimizer`` must equal the JAX class bit for bit (the same C++
arithmetic over the same flat layout; ``nvme`` swaps the moments through
files in 4096-element groups).  The engines start from the same JAX
weights and take the same numpy batches at fp32; the bound is
``tests/unit/test_offload.py::test_engine_offload_matches_baseline``'s,
rtol 2e-4 and atol 1e-5 (the two frameworks sum in other orders).
``tests/conftest.py`` gives JAX 8 CPU devices, so both engines get the
same ``train_batch_size`` and GAS (JAX splits each micro-batch over dp=8).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.zero.offload import HostOffloadOptimizer as JHost
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.ops.optimizers import FusedAdam
from deepspeed_tpu_torch.runtime.zero.offload import (HostOffloadOptimizer
                                                      as THost, HostRing)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """One OpenMP thread a pytest-xdist worker: the host library's pool
    (shared with the JAX package's) is the process's, sized here rather
    than at import so that collecting the file builds nothing."""
    cpu_adam.set_num_threads(1)

OPTIMIZERS = [("adam", {"lr": 1e-2}),
              ("adamw", {"lr": 1e-2, "weight_decay": 0.1,
                         "betas": [0.9, 0.95]}),
              ("adam", {"lr": 1e-2, "adam_w_mode": False,
                        "weight_decay": 0.1, "bias_correction": False}),
              ("adagrad", {"lr": 1e-2, "weight_decay": 0.01})]


def _leaves(rng):
    return [rng.normal(size=s).astype(np.float32)
            for s in [(70, 130), (9100,), (3, 4, 5)]]


@pytest.mark.parametrize("device", ["cpu", "nvme"])
@pytest.mark.parametrize("opt", range(len(OPTIMIZERS)),
                         ids=["adam", "adamw", "adam-l2", "adagrad"])
def test_host_offload_matches_jax_bit_for_bit(device, opt, tmp_path):
    name, params = OPTIMIZERS[opt]
    rng = np.random.default_rng(2)
    leaves = _leaves(rng)
    kw = dict(device=device, nvme_path=str(tmp_path), sub_group_size=4096)
    j = JHost(leaves, name, params, **kw)
    t = THost(leaves, name, params, **kw)
    try:
        for step in range(3):
            grads = [rng.normal(size=l.shape).astype(np.float32)
                     for l in leaves]
            want = j.step(grads, lr=3e-3 / (step + 1))
            got = t.step(grads, lr=3e-3 / (step + 1))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))
        sj, st = j.state_dict(), t.state_dict()
        assert sorted(st) == sorted(sj)
        for key, want in sj.items():
            np.testing.assert_array_equal(np.asarray(st[key]),
                                          np.asarray(want))
        assert t.applied_steps == 3
        assert t.global_grad_norm(grads) == pytest.approx(
            j.global_grad_norm(grads), rel=1e-12)
    finally:
        j.close()
        t.close()


def test_state_dict_round_trips_between_tiers(tmp_path):
    """nvme -> cpu through ``state_dict``, and the next steps agree bit for
    bit (JAX's ``test_host_offload_state_dict_roundtrip``, exact here)."""
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=(17,)).astype(np.float32)]
    a = THost(leaves, "adam", {"lr": 1e-2}, device="nvme",
              nvme_path=str(tmp_path), sub_group_size=8)
    a.step([rng.normal(size=(17,)).astype(np.float32)])
    b = THost(leaves, "adam", {"lr": 1e-2}, device="cpu")
    b.load_state_dict(a.state_dict())
    g = rng.normal(size=(17,)).astype(np.float32)
    np.testing.assert_array_equal(a.step([g])[0], b.step([g])[0])
    assert a.applied_steps == b.applied_steps == 2
    a.close()
    b.close()


class _Chunked(HostRing):
    """A host ring that hands the optimizer pieces of ``chunk``
    elements."""

    def __init__(self, grads, compute, chunk):
        super().__init__(grads, compute)
        self.chunk = chunk
        self.seen = []

    def put(self, start, end, out):
        self.seen.append((start, end))
        super().put(start, end, out)


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_stepping_in_pieces_gives_the_whole_steps_bits(device, tmp_path):
    """``step_stream`` in 1000-element pieces (across leaf and group
    boundaries) equals whole steps, and its bf16 output is the master's
    bf16 rounding."""
    rng = np.random.default_rng(4)
    leaves = _leaves(rng)
    kw = dict(device=device, nvme_path=str(tmp_path), sub_group_size=4096)
    whole = THost(leaves, "adamw", {"lr": 1e-2}, **kw)
    pieces = THost(leaves, "adamw", {"lr": 1e-2}, **kw)
    compute = torch.empty(whole.total, dtype=torch.bfloat16)
    for _ in range(3):
        g = rng.normal(size=whole.total).astype(np.float32)
        whole.step([g[o:o + n] for o, n in zip(whole.offsets, whole.sizes)],
                   lr=1e-2)
        ring = _Chunked(g, compute, 1000)
        pieces.step_stream(ring, lr=1e-2)
        assert ring.seen == pieces.pieces(1000)
        assert all(e - s <= 1000 for s, e in ring.seen)
    np.testing.assert_array_equal(pieces.master, whole.master)
    assert torch.equal(compute, torch.from_numpy(whole.master).to(
        torch.bfloat16))
    assert pieces.opt.step_count == whole.opt.step_count == 3
    whole.close()
    pieces.close()


# ------------------------------------------------------------------ engines
def _config(device, tmp_path, opt="adamw", **extra):
    conf = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "steps_per_print": 100,
            "zero_optimization": {"stage": 2,
                                  "offload_optimizer": {
                                      "device": device,
                                      "nvme_path": str(tmp_path)},
                                  "sub_group_size": 4096}}
    if opt == "adamw":
        conf["optimizer"] = {"type": "AdamW",
                             "params": {"lr": 1e-3, "weight_decay": 0.01}}
        conf["scheduler"] = {"type": "WarmupLR",
                             "params": {"warmup_min_lr": 1e-4,
                                        "warmup_max_lr": 1e-3,
                                        "warmup_num_steps": 3,
                                        "warmup_type": "linear"}}
        conf["gradient_clipping"] = 0.5
    elif opt == "adagrad":
        conf["optimizer"] = {"type": "Adagrad", "params": {"lr": 1e-2}}
    else:
        conf["optimizer"] = {"type": "Adam", "params": {"lr": 1e-3}}
    conf.update(extra)
    return conf


def _pair(family, conf):
    """A JAX engine and a port engine (on the CPU) from the same JAX
    weights."""
    if family == "gpt2":
        jmod, tmod = jgpt2, tgpt2
        cfg, tcfg = jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()
    else:
        jmod, tmod = jllama, tllama
        cfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=jmod.build(cfg), config=conf)
    start = jax.device_get(jeng.state["params"])
    teng, opt, *_ = deepspeed_tpu_torch.initialize(
        model=tmod.build(tcfg), config=conf,
        model_parameters=tmod.params_from_jax(start), device="cpu")
    return cfg, jeng, teng, opt


@pytest.mark.parametrize("family,device,opt", [
    ("gpt2", "cpu", "adamw"), ("gpt2", "nvme", "adam"),
    ("gpt2", "cpu", "adagrad"), ("llama", "cpu", "adamw")])
def test_offload_engine_matches_jax(family, device, opt, tmp_path):
    """Stage 2 with ``offload_optimizer``, 4 steps: the losses, grad norms,
    LRs (WarmupLR read at the applied steps), and the host masters and
    moments, against the JAX offload engine."""
    cfg, jeng, teng, topt = _pair(family, _config(device, tmp_path, opt))
    assert topt is teng._offload_opt.opt
    assert isinstance(topt, cpu_adam.DeepSpeedCPUAdagrad if opt == "adagrad"
                      else cpu_adam.DeepSpeedCPUAdam)
    rng = np.random.default_rng(5)
    for _ in range(4):
        ids = rng.integers(0, cfg.vocab_size, (16, 25)).astype(np.int32)
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=2e-4, atol=1e-5)
    if opt != "adagrad":
        # (Adagrad's first update is lr g / |g|: an element whose gradient
        # sums to ~0 in a different order moves by +-lr; its losses hold)
        want = jax.tree_util.tree_leaves(
            jax.device_get(jeng.state["params"]))
        got = jax.tree_util.tree_leaves(teng.state["params"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), w, rtol=2e-4,
                                       atol=1e-5)
    jsd, tsd = jeng._offload_opt.state_dict(), teng._offload_opt.state_dict()
    assert tsd["applied_steps"] == jsd["applied_steps"] == 4
    teng.close()


def test_offload_matches_the_resident_engine_in_bf16():
    """bf16 compute, offload against the port's own stage-0 engine from the
    same weights: the device holds bf16 weights and one f32 gradient
    accumulator, and the first step's gradients are the resident engine's
    bit for bit.  The host Adam rounds otherwise than optax (a master ulp
    apart after one step), and in bf16 such an ulp can flip a weight's
    rounding, so after that the trajectories are held by their losses."""
    cfg = tgpt2.GPT2Config.tiny()
    params = tgpt2.init_params(cfg, torch.Generator().manual_seed(0))
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 100}
    base, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(cfg), config=conf, model_parameters=params,
        device="cpu")
    off, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(cfg), device="cpu", model_parameters=params,
        config={**conf, "zero_optimization": {
            "stage": 1, "offload_optimizer": {"device": "cpu"}}})
    assert off._dev_flat.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in off._leaves)
    assert off._dev_grad.dtype == torch.float32
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (4, 33))
    for micro in base._micro_batches({"input_ids": ids}):
        base._micro_loss(micro).backward()
        off._micro_loss(micro).backward()
    assert all(p.grad is None for p in off._leaves)
    assert torch.equal(off._dev_grad, torch.cat(
        [p.grad.reshape(-1) for p in base._leaves]))
    for p in base._leaves:
        p.grad = None
    off._dev_grad.zero_()
    for _ in range(3):
        ids = rng.integers(0, cfg.vocab_size, (4, 33))
        _, mb = base.train_batch({"input_ids": ids})
        _, mo = off.train_batch({"input_ids": ids})
        np.testing.assert_allclose(mo["loss"], mb["loss"], rtol=2e-4)
        np.testing.assert_allclose(mo["grad_norm"], mb["grad_norm"],
                                   rtol=2e-3)
    # the compute copy is the masters' bf16 rounding
    assert torch.equal(off._dev_flat, torch.from_numpy(
        off._offload_opt.master).to(torch.bfloat16))


def test_micro_step_shims_under_offload():
    """``engine(batch)`` / ``backward`` / ``step`` give train_batch's
    update within f32 rounding (the 1/gas scale applied per micro-step)."""
    cfg = tgpt2.GPT2Config.tiny()
    params = tgpt2.init_params(cfg, torch.Generator().manual_seed(1))
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"offload_optimizer": {"device": "cpu"}}}
    a, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(cfg), config=conf, model_parameters=params,
        device="cpu")
    b, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(cfg), config=conf, model_parameters=params,
        device="cpu")
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 17))
    _, ma = a.train_batch({"input_ids": ids})
    for i in range(2):
        loss = b({"input_ids": ids[2 * i:2 * i + 2]})
        b.backward(loss)
        b.step()
    assert b.global_steps == 1
    np.testing.assert_allclose(b.get_global_grad_norm(), ma["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(b._offload_opt.master, a._offload_opt.master,
                               rtol=1e-5, atol=1e-7)


def test_offload_refuses_a_client_optimizer_with_the_jax_words():
    cfg = tgpt2.GPT2Config.tiny()
    with pytest.raises(ValueError, match="offload_optimizer requires a "
                       "config-specified optimizer"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.build(cfg), optimizer=FusedAdam(), device="cpu",
            config={"train_batch_size": 2, "zero_optimization": {
                "stage": 2, "offload_optimizer": {"device": "cpu"}}})


def test_llama_offload_remat_route_matches_plain():
    """The card's llama route (remat, the flash op's plain versions here)
    under offload gives the plain route's first losses."""
    losses = []
    for kw in ({"remat": True, "use_flash": True},
               {"remat": False, "use_flash": False}):
        tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), **kw)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.build(tcfg), device="cpu",
            config={"train_batch_size": 2, "gradient_accumulation_steps": 2,
                    "seed": 3,
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                    "zero_optimization": {"stage": 3, "offload_optimizer": {
                        "device": "cpu"}}})
        rng = np.random.default_rng(9)
        losses.append([eng.train_batch(
            {"input_ids": rng.integers(0, tcfg.vocab_size, (2, 17))}
        )[1]["loss"] for _ in range(2)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
