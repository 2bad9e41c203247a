"""ZeRO-Infinity parameter streaming in the port
(``deepspeed_tpu_torch/runtime/zero/param_stream.py`` and the streaming
path of ``runtime/engine.py``), mirroring
``tests/unit/test_param_stream.py``'s five tests and their bounds, and
held against the JAX streaming engine.

Bounds: the streamed gradients equal autograd's within 2e-6 (the JAX
test's); streamed against the resident offload engine within atol 8e-3
over 4 steps (the JAX test's: the two graphs sum in other orders and Adam
amplifies f32 rounding); the port's streaming engine against the JAX one
within the same 8e-3.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.zero.param_stream import (StreamedParamStore
                                                     as JStore)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.runtime.zero.param_stream import StreamedParamStore

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """One OpenMP thread a pytest-xdist worker: the host library's pool
    (shared with the JAX package's) is the process's, sized here rather
    than at import so that collecting the file builds nothing."""
    cpu_adam.set_num_threads(1)


def _cfg(stream: bool, **over):
    zero = {"stage": 0, "offload_optimizer": {"device": "cpu"}}
    if stream:
        zero["offload_param"] = {"device": "cpu"}
    cfg = {"train_micro_batch_size_per_gpu": 1,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": zero, "steps_per_print": 100}
    cfg.update(over)
    return cfg


def _run(config, steps=4, seed=0, model=None, params=None):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model or tgpt2.build(tgpt2.GPT2Config.tiny()), config=config,
        model_parameters=params, device="cpu")
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        batch = {"input_ids": rng.integers(
            0, 512, size=(engine.train_batch_size(), 33)).astype(np.int32)}
        _, m = engine.train_batch(batch)
        losses.append(float(m["loss"]))
    return engine, losses


def test_streamed_grads_match_autodiff():
    """The streamed block backward (host round trip) reproduces autograd's
    gradients, and the JAX store's, to float rounding."""
    cfg = tgpt2.GPT2Config.tiny()
    jparams = jax.device_get(jgpt2.init_params(jgpt2.GPT2Config.tiny(),
                                               jax.random.PRNGKey(0)))
    params = tgpt2.params_from_jax(jparams)
    model = tgpt2.build(cfg)
    hooks = model.pipeline_hooks
    ids = np.random.default_rng(0).integers(0, 512, (2, 33))
    batch = {"input_ids": torch.as_tensor(ids)}

    ref = {k: ({n: t.clone().requires_grad_() for n, t in v.items()}
               if isinstance(v, dict) else v.clone().requires_grad_())
           for k, v in params.items()}
    model.loss_fn(ref, batch).backward()

    store = StreamedParamStore(params["blocks"], torch.float32)
    blk = store.streamed_block(lambda layer, x: hooks["block_fn"](layer, x))
    resident = {k: v.clone().requires_grad_() for k, v in params.items()
                if k != "blocks"}
    x = hooks["embed_fn"](resident, batch["input_ids"][:, :-1])
    for i in range(cfg.num_layers):
        x = blk(i, x)
    hooks["head_loss_fn"](resident, x, batch["input_ids"][:, 1:]).backward()
    block_grads = store.pop_grads()
    for name, gs in zip(store.names, block_grads):
        np.testing.assert_allclose(ref["blocks"][name].grad.numpy(), gs,
                                   atol=2e-6)
    for k in ("wte", "wpe", "lnf_scale", "lnf_bias"):
        np.testing.assert_allclose(ref[k].grad.numpy(),
                                   resident[k].grad.numpy(), atol=2e-6)
    # the JAX store's streamed gradients of the same step
    import jax.numpy as jnp

    jspec = jgpt2.build(jgpt2.GPT2Config.tiny())
    jhooks = jspec.pipeline_hooks
    jstore = JStore(jparams["blocks"], jnp.float32)
    jblk = jstore.streamed_block(
        lambda layer, x: jhooks["block_fn"](layer, x, None))
    jres = {k: v for k, v in jparams.items() if k != "blocks"}
    jres["blocks"] = {}

    def jloss(p):
        x = jhooks["embed_fn"](p, ids[:, :-1])
        x, _ = jax.lax.scan(lambda x, i: (jblk(i, x), None), x,
                            jnp.arange(cfg.num_layers))
        return jhooks["head_loss_fn"](p, x, ids[:, 1:])

    jax.block_until_ready(jax.jit(jax.grad(jloss))(jres))
    jax.effects_barrier()
    jgrads = dict(zip(sorted(jparams["blocks"]), jstore.pop_grads()))
    for name, gs in zip(store.names, block_grads):
        np.testing.assert_allclose(gs, jgrads[name], atol=2e-6)
    assert store.pop_grads()[0].any() == 0     # popped: cleared


def test_streamed_matches_resident_offload():
    """Loss trajectories agree with the resident offload engine (the JAX
    test's bound), the device holds no block, and the store two layers."""
    _, base = _run(_cfg(stream=False))
    engine, stream = _run(_cfg(stream=True))
    np.testing.assert_allclose(stream, base, atol=8e-3)
    assert engine.state["params"]["blocks"] == {}
    assert "blocks" not in engine._params
    assert engine._param_store.num_layers == 2
    assert engine._param_store.compute_flat.dtype == torch.float32


def test_streamed_with_clipping_matches():
    """The host clip over resident and streamed gradients together."""
    _, base = _run(_cfg(stream=False, gradient_clipping=0.1))
    engine, stream = _run(_cfg(stream=True, gradient_clipping=0.1))
    np.testing.assert_allclose(stream, base, atol=8e-3)
    assert engine.get_global_grad_norm() > 0.1


def test_streamed_matches_the_jax_streaming_engine():
    """The port's streaming engine and the JAX one from the same weights
    and batches (8 CPU devices: JAX's dp=8 takes the same global batch),
    with clipping."""
    conf = _cfg(stream=True, gradient_clipping=0.5)
    conf.pop("train_micro_batch_size_per_gpu")
    conf["train_batch_size"] = 16
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.build(jgpt2.GPT2Config.tiny()), config=conf)
    start = jax.device_get(jeng.state["params"])
    start["blocks"] = jeng._param_store.master_blocks()
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tgpt2.GPT2Config.tiny()), config=conf,
        model_parameters=tgpt2.params_from_jax(start), device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):
        ids = rng.integers(0, 512, (16, 33)).astype(np.int32)
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), atol=8e-3)
    for name, m in jeng._param_store.master_blocks().items():
        np.testing.assert_allclose(teng._param_store.master_blocks()[name],
                                   m, atol=8e-3)


def test_streamed_checkpoint_roundtrip(tmp_path):
    engine, _ = _run(_cfg(stream=True), steps=2)
    engine.save_checkpoint(str(tmp_path / "ck"))
    master_before = [m.copy() for m in engine._param_store.master]

    engine2, _ = _run(_cfg(stream=True), steps=1, seed=9)
    engine2.load_checkpoint(str(tmp_path / "ck"))
    for a, b in zip(master_before, engine2._param_store.master):
        np.testing.assert_array_equal(a, b)
    # the compute copy follows the restored masters
    for c, m in zip(engine2._param_store.compute,
                    engine2._param_store.master):
        np.testing.assert_array_equal(c.numpy(), m)
    rng = np.random.default_rng(3)
    batch = {"input_ids": rng.integers(
        0, 512, size=(engine2.train_batch_size(), 33)).astype(np.int32)}
    _, m = engine2.train_batch(batch)
    assert np.isfinite(m["loss"])


def test_streamed_requires_offload_optimizer_and_no_dropout():
    with pytest.raises(ValueError, match="offload_param requires"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.build(tgpt2.GPT2Config.tiny()), device="cpu",
            config={"train_micro_batch_size_per_gpu": 1,
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                    "zero_optimization": {
                        "stage": 0, "offload_param": {"device": "cpu"}}})
    model = tgpt2.build(tgpt2.GPT2Config.tiny())
    model.pipeline_hooks["dropout"] = 0.1
    with pytest.raises(ValueError, match="offload_param does not support "
                       "dropout yet"):
        deepspeed_tpu_torch.initialize(model=model, config=_cfg(True),
                                       device="cpu")


def test_streamed_llama_in_bf16_runs_the_streamed_route():
    """A tiny llama with bf16 compute and remat (the card's phase 16 (d)
    route, the flash op's plain version here): the blocks' compute copy is
    the block masters' bf16 rounding after every step, and the losses fall
    on a repeated batch."""
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), remat=True,
                               use_flash=True)
    conf = _cfg(stream=True, bf16={"enabled": True})
    conf["optimizer"]["params"]["lr"] = 3e-3
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.build(tcfg), config=conf, device="cpu")
    store = engine._param_store
    ids = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 17))
    losses = [engine.train_batch({"input_ids": ids})[1]["loss"]
              for _ in range(3)]
    assert losses[-1] < losses[0]
    assert torch.equal(store.compute_flat,
                       torch.from_numpy(engine._block_opt.master).to(
                           torch.bfloat16))
    assert not store.grad_flat.any()
