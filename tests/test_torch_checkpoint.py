"""Checkpoints in the port (``deepspeed_tpu_torch/runtime/checkpointing.py``
and ``DeepSpeedEngine.save_checkpoint`` / ``load_checkpoint``) against the
JAX package's layout and semantics: ``<dir>/latest``, ``<dir>/<tag>/`` with
the default tag ``global_step{N}``, ``ds_meta.json`` with the JAX keys, the
host optimizer's ``offload_optimizer.p0.npz`` and the streamed blocks'
``offload_blocks.npz``; ``client_state``, ``load_optimizer_states=False``,
``load_module_only`` and a missing ``latest``.  A resume (save after 2
steps, 1 more step) must equal the uninterrupted run bit for bit, at stage
0, with offload and with streaming.
"""

import json
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import cpu_adam

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """One OpenMP thread a pytest-xdist worker: the host library's pool
    (shared with the JAX package's) is the process's, sized here rather
    than at import so that collecting the file builds nothing."""
    cpu_adam.set_num_threads(1)

ZERO = {
    "stage0": {"stage": 0},
    "offload": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
    "nvme": {"stage": 3, "offload_optimizer": {"device": "nvme"},
             "sub_group_size": 4096},
    "stream": {"stage": 0, "offload_optimizer": {"device": "cpu"},
               "offload_param": {"device": "cpu"}},
}


def _config(zero, tmp_path=None):
    zero = dict(zero)
    if "offload_optimizer" in zero and tmp_path is not None:
        zero["offload_optimizer"] = {**zero["offload_optimizer"],
                                     "nvme_path": str(tmp_path)}
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 1e-4,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 3}},
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "zero_optimization": zero}


def _engine(zero, tmp_path=None, seed=0):
    cfg = tgpt2.GPT2Config.tiny()
    params = tgpt2.init_params(cfg, torch.Generator().manual_seed(seed))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(cfg), config=_config(zero, tmp_path),
        model_parameters=params, device="cpu")
    return eng


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, (4, 33))} for _ in range(n)]


def _weights(eng) -> np.ndarray:
    leaves = []

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append(v.detach().reshape(-1).numpy())
    walk(eng.params)
    return np.concatenate(leaves)


@pytest.mark.parametrize("kind", list(ZERO))
def test_resume_is_bit_identical(kind, tmp_path):
    """2 steps, save, 1 more; against a fresh engine (other weights) that
    loads the checkpoint and takes the same step: the losses, the
    weights, the LR and the counters agree bit for bit."""
    batches = _batches(3)
    a = _engine(ZERO[kind], tmp_path / "a")
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path / "ck"))
    _, ma = a.train_batch(batches[2])
    b = _engine(ZERO[kind], tmp_path / "b", seed=5)
    path, client = b.load_checkpoint(str(tmp_path / "ck"))
    assert path == str(tmp_path / "ck" / "global_step2") and client == {}
    assert (b.global_steps, b.global_samples, b.micro_steps) == (2, 8, 4)
    _, mb = b.train_batch(batches[2])
    assert mb["loss"] == ma["loss"]
    assert mb["grad_norm"] == ma["grad_norm"] and mb["lr"] == ma["lr"]
    np.testing.assert_array_equal(_weights(b), _weights(a))
    if kind != "stage0":
        sa, sb = a._offload_opt.state_dict(), b._offload_opt.state_dict()
        for key in sa:
            np.testing.assert_array_equal(np.asarray(sb[key]),
                                          np.asarray(sa[key]))
    # the device copy was refreshed from the restored masters
    if kind in ("offload", "nvme"):
        assert torch.equal(b._dev_flat, torch.from_numpy(
            b._offload_opt.master))
    a.close()
    b.close()


def test_layout_and_meta_keys_match_jax(tmp_path):
    """The files of a save and the ``ds_meta.json`` keys of the JAX
    engine's own save."""
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.build(jgpt2.GPT2Config.tiny()),
        config={**_config(ZERO["offload"]), "train_batch_size": 16})
    jeng.save_checkpoint(str(tmp_path / "jax"))
    eng = _engine(ZERO["stream"])
    eng.train_batch(_batches(1)[0])
    out = eng.save_checkpoint(str(tmp_path / "port"),
                              client_state={"epoch": 3})
    assert out == str(tmp_path / "port" / "global_step1")
    with open(tmp_path / "port" / "latest") as f:
        assert f.read() == "global_step1"
    with open(tmp_path / "jax" / "latest") as f:
        assert f.read() == "global_step0"
    with open(tmp_path / "jax" / "global_step0" / "ds_meta.json") as f:
        jmeta = json.load(f)
    with open(os.path.join(out, "ds_meta.json")) as f:
        meta = json.load(f)
    assert sorted(meta) == sorted(jmeta)
    assert meta["client_state"] == {"epoch": 3}
    assert meta["global_steps"] == 1 and meta["zero_stage"] == 0
    assert sorted(meta["mesh"]) == sorted(jmeta["mesh"])
    names = set(os.listdir(out))
    assert {"ds_meta.json", "state", "offload_optimizer.p0.npz",
            "offload_blocks.npz"} <= names
    assert {"offload_optimizer.p0.npz", "state"} <= set(
        os.listdir(tmp_path / "jax" / "global_step0"))
    with np.load(os.path.join(out, "offload_optimizer.p0.npz")) as z:
        assert sorted(z.files) == sorted(jeng._offload_opt.state_dict())
    # a tag of the caller's, without moving latest
    eng.save_checkpoint(str(tmp_path / "port"), tag="mine",
                        save_latest=False)
    with open(tmp_path / "port" / "latest") as f:
        assert f.read() == "global_step1"
    assert eng.load_checkpoint(str(tmp_path / "port"), tag="mine")[0] == \
        str(tmp_path / "port" / "mine")
    eng.close()


def test_missing_latest_loads_nothing(tmp_path):
    eng = _engine(ZERO["stage0"])
    before = _weights(eng).copy()
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})
    np.testing.assert_array_equal(_weights(eng), before)
    assert eng.global_steps == 0


@pytest.mark.parametrize("kind", ["stage0", "offload"])
@pytest.mark.parametrize("mode", ["no_optimizer_states", "module_only"])
def test_partial_loads_keep_the_optimizer_fresh(kind, mode, tmp_path):
    """``load_optimizer_states=False`` and ``load_module_only=True``
    restore the weights and not the optimizer state (fresh moments and
    update count, so the LR schedule restarts), as the JAX engine does;
    the counters come back with the meta file."""
    a = _engine(ZERO[kind])
    for b in _batches(2):
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path / "ck"), client_state={"k": 1})
    b = _engine(ZERO[kind], seed=7)
    kw = ({"load_optimizer_states": False} if mode == "no_optimizer_states"
          else {"load_module_only": True})
    _, client = b.load_checkpoint(str(tmp_path / "ck"), **kw)
    assert client == {"k": 1} and b.global_steps == 2
    np.testing.assert_array_equal(_weights(b), _weights(a))
    if kind == "offload":
        assert b._offload_opt.applied_steps == 0
        assert not b._offload_opt.state_dict()["exp_avg"].any()
        assert torch.equal(b._dev_flat,
                           torch.from_numpy(b._offload_opt.master))
    else:
        assert b._opt_state.count == 0
        assert not any(m.any() for m in b._opt_state.mu)
