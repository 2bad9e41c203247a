"""fp16 training in the PyTorch port against the JAX package on the CPU:
the loss scaler (``runtime/fp16/loss_scaler.py``), the engine's fp16 step
(``runtime/engine.py``), the flash-attention plain versions in float16 and
an fp16 checkpoint's resume.

Tolerances: the scaler's state is compared bit for bit (the same float32
and int32 arithmetic).  The fp16 engines compute their forward and
backward in float16 with different roundings (XLA fuses and rounds once,
PyTorch rounds each op), so the losses are held within 1e-2 relative; the
overflow flags, loss scales and skip counts must be equal step for step.
Flash attention in float16: the JAX kernel (interpret mode) rounds the
scaled queries, P and dS to float16 where the port's plain versions keep
float32, so o is held at 4e-3 and dq, dk, dv at 2e-2 (atol and rtol: a few
float16 ulps of values of order 1-10).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

torch.set_num_threads(1)

FP16_MAX = 65504.0


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    cpu_adam.set_num_threads(1)


# --------------------------------------------------------------- the scaler
#: overflow patterns over 14 steps: runs of overflows, isolated ones, and
#: good streaks long enough to reach scale_window
PATTERNS = [
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0],
]
SCALER_CASES = [
    ("hysteresis 1", dict(delayed_shift=1), dict(init_scale=2.0**16,
                                                 delayed_shift=1)),
    ("hysteresis 2", dict(delayed_shift=2), dict(init_scale=2.0**16,
                                                 delayed_shift=2)),
    ("consecutive hysteresis", dict(delayed_shift=2,
                                    consecutive_hysteresis=True),
     dict(init_scale=2.0**16, delayed_shift=2)),
    ("static", dict(dynamic=False), dict(init_scale=128.0)),
    ("min_scale floor", dict(delayed_shift=1, min_scale=2.0**14),
     dict(init_scale=2.0**15, delayed_shift=1)),
]


def _fields(state):
    return [np.asarray(getattr(state, name)) for name in tls.FIELDS]


@pytest.mark.parametrize("pattern", range(len(PATTERNS)))
@pytest.mark.parametrize("case", SCALER_CASES, ids=[c[0] for c in
                                                    SCALER_CASES])
def test_update_scale_matches_jax_bit_for_bit(case, pattern):
    _, kw, init = case
    kw = dict(kw, scale_window=3)
    j_update = jax.jit(functools.partial(jls.update_scale, **kw))
    j = jls.LossScaleState.create(**init)
    t = tls.LossScaleState.create(**init)
    for step, ov in enumerate(PATTERNS[pattern]):
        j = j_update(j, jnp.asarray(bool(ov)))
        t = tls.update_scale(t, torch.tensor(bool(ov)), **kw)
        for name, got, want in zip(tls.FIELDS, _fields(t), _fields(j)):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(
                got.view(np.uint32) if got.dtype == np.float32 else got,
                want.view(np.uint32) if want.dtype == np.float32 else want,
                err_msg=f"{name} at step {step}")


def test_scaler_fields_and_overflow_check_match_jax():
    assert tls.FIELDS == jls.LossScaleState._fields
    for bad in (np.inf, -np.inf, np.nan):
        leaves = [np.ones((3, 4), np.float32), np.arange(5, dtype=np.float32)]
        leaves[1][2] = bad
        assert bool(tls.has_overflow([torch.from_numpy(x) for x in leaves]))
        assert bool(jls.has_overflow([jnp.asarray(x) for x in leaves]))
    clean = [torch.full((2, 2), FP16_MAX), torch.zeros(3)]
    assert not bool(tls.has_overflow(clean))


# --------------------------------------------------------------- the engine
def _fp16_config(zero, extra=None):
    return {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "fp16": {"enabled": True, "initial_scale_power": 32,
                     "loss_scale_window": 3},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "zero_optimization": {"stage": zero, **(extra or {})}}


ENGINE_CASES = [("zero0", 0, None), ("zero2", 2, None),
                ("offload", 2, {"offload_optimizer": {"device": "cpu"}})]
#: steps: from 2^32 the scale halves (after the first overflow spends the
#: hysteresis of 2) until the scaled gradients fit float16, then the
#: window of 3 good steps doubles it again
FP16_STEPS = 20


def _max_scaled_grad(tcfg, params, ids, scale):
    """The largest |gradient| of ``loss x scale`` over the float16 weights
    for the first micro-batch (the weights of every step up to the first
    good one: overflowing steps update nothing)."""
    p16 = {k: ({n: t.half().requires_grad_() for n, t in v.items()}
               if isinstance(v, dict) else v.half().requires_grad_())
           for k, v in params.items()}
    loss = tgpt2.loss_from_batch(tcfg, p16, {"input_ids": torch.as_tensor(
        ids[:8]).long()})
    (loss.float() * scale).backward()
    leaves = [t for v in p16.values()
              for t in (v.values() if isinstance(v, dict) else [v])]
    return max(t.grad.float().abs().max().item() for t in leaves)


@pytest.mark.parametrize("name,zero,extra", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_fp16_engine_matches_jax(name, zero, extra):
    """Tiny GPT-2 (2 layers, 4 heads, d = 64), GAS 2, from the same JAX
    weights: the overflow flags, loss scales and skip counts equal step for
    step from 2^32 down through the boundary and back up a window, the
    losses within 1e-2."""
    cfg = jgpt2.GPT2Config.tiny()
    tcfg = tgpt2.GPT2Config.tiny()
    conf = _fp16_config(zero, extra)
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=jgpt2.build(cfg), config=conf)
    start = tgpt2.params_from_jax(jax.device_get(jeng.state["params"]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), config=conf, model_parameters=start,
        device="cpu")
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                            (16, 33)).astype(np.int32)
    got, want = [], []
    for _ in range(FP16_STEPS):
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        want.append((bool(jm["overflow"]), float(jm["loss_scale"]),
                     int(jm["skipped"])))
        got.append((bool(tm["overflow"]), tm["loss_scale"], tm["skipped"]))
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-2)
    boundary = next(i for i, (ov, _, _) in enumerate(want) if not ov)
    scale = want[boundary][1]
    at, twice = (_max_scaled_grad(tcfg, start, ids, x)
                 for x in (scale, 2 * scale))
    print(f"{name}: the first good step is {boundary} at scale {scale:.0f}: "
          f"largest scaled gradient {at:.1f} (at twice the scale "
          f"{twice:.1f}) against {FP16_MAX}")
    assert got == want
    assert teng.skipped_steps == want[-1][2] == jeng.skipped_steps
    assert teng.loss_scale() == jeng.loss_scale()
    assert teng.global_steps == FP16_STEPS
    assert 0 < boundary < FP16_STEPS - 3


def test_micro_step_shims_scale_as_train_batch():
    """``forward`` / ``backward`` / ``step`` under fp16 land where one
    ``train_batch`` of the same rows lands, overflow included."""
    tcfg = tgpt2.GPT2Config.tiny()
    params = tgpt2.params_from_jax(jax.device_get(jgpt2.init_params(
        jgpt2.GPT2Config.tiny(), jax.random.PRNGKey(3))))
    conf = dict(_fp16_config(0), fp16={"enabled": True,
                                       "initial_scale_power": 12})
    ids = np.random.default_rng(5).integers(0, tcfg.vocab_size, (16, 17))
    engines = [deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), config=conf, device="cpu",
        model_parameters=params)[0] for _ in range(2)]
    _, m0 = engines[0].train_batch({"input_ids": ids})
    for half in (ids[:8], ids[8:]):
        engines[1].backward(engines[1]({"input_ids": half}))
        engines[1].step()
    m1 = engines[1]._cached_metrics
    assert (m0["overflow"], m0["loss_scale"], m0["skipped"]) == \
        (m1["overflow"], m1["loss_scale"], m1["skipped"])
    for a, b in zip(engines[0]._leaves, engines[1]._leaves):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_fp16_checkpoint_resumes_bit_identically(tmp_path):
    """An fp16 engine saved after 3 steps and loaded into a fresh one
    continues with the same bits as the original, the scaler included;
    the scaler's saved fields carry JAX's names."""
    tcfg = tgpt2.GPT2Config.tiny()
    params = tgpt2.params_from_jax(jax.device_get(jgpt2.init_params(
        jgpt2.GPT2Config.tiny(), jax.random.PRNGKey(3))))
    conf = dict(_fp16_config(0), fp16={"enabled": True,
                                       "initial_scale_power": 18,
                                       "loss_scale_window": 2})
    ids = np.random.default_rng(6).integers(0, tcfg.vocab_size, (16, 17))

    def engine():
        return deepspeed_tpu_torch.initialize(
            model=tgpt2.build(tcfg), config=conf, device="cpu",
            model_parameters=params)[0]

    a = engine()
    for _ in range(3):
        a.train_batch({"input_ids": ids})
    a.save_checkpoint(str(tmp_path))
    saved = torch.load(tmp_path / "global_step3" / "state" /
                       "model_states.pt")
    assert tuple(saved["scaler"]) == jls.LossScaleState._fields
    b = engine()
    b.load_checkpoint(str(tmp_path))
    assert b.loss_scale() == a.loss_scale()
    assert b.skipped_steps == a.skipped_steps
    for _ in range(3):
        _, ma = a.train_batch({"input_ids": ids})
        _, mb = b.train_batch({"input_ids": ids})
        assert (ma["loss"], ma["loss_scale"], ma["skipped"]) == \
            (mb["loss"], mb["loss_scale"], mb["skipped"])
    for x, y in zip(a._leaves, b._leaves):
        assert torch.equal(x, y)


def test_fp16_config_matches_jax():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig as
                                                    TConfig,
                                                    DeepSpeedConfigError)

    conf = {"train_batch_size": 8,
            "fp16": {"enabled": True, "loss_scale": 0,
                     "initial_scale_power": 12, "loss_scale_window": 50,
                     "hysteresis": 3, "min_loss_scale": 4}}
    want, got = JConfig(dict(conf), world_size=1), TConfig(dict(conf))
    assert got.dynamic_loss_scale_args == want.dynamic_loss_scale_args
    assert got.precision_dtype == want.precision_dtype == "float16"
    assert got.loss_scale == want.loss_scale
    with pytest.raises(DeepSpeedConfigError, match="cannot both"):
        TConfig({"train_batch_size": 8, "fp16": {"enabled": True},
                 "bf16": {"enabled": True}})


def test_static_loss_scale_engine():
    """``loss_scale`` > 0: a fixed scale; an overflowing step is still
    skipped and counted, and the scale never moves."""
    tcfg = tgpt2.GPT2Config.tiny()
    conf = dict(_fp16_config(0), fp16={"enabled": True,
                                       "loss_scale": 2.0**30})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tcfg), config=conf, device="cpu")
    ids = np.random.default_rng(7).integers(0, tcfg.vocab_size, (16, 17))
    for step in range(2):
        _, m = eng.train_batch({"input_ids": ids})
        assert m["overflow"] and m["loss_scale"] == 2.0**30
        assert m["skipped"] == step + 1 == eng.skipped_steps
    assert eng.get_lr() == [1e-3]


# ------------------------------------------------------------------- flash
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,s,d", [(2, 2, 40, 64), (4, 2, 72, 64),
                                       (2, 1, 48, 128)])
def test_flash_plain_fp16_matches_jax_kernel(causal, h, hkv, s, d):
    """The port's plain forward and backward in float16 (``flash_attention``
    on CPU tensors) against the JAX ``flash_attention`` in float16, its
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(s + d)
    q, do = (rng.standard_normal((2, h, s, d)).astype(np.float16)
             for _ in range(2))
    k, v = (rng.standard_normal((2, hkv, s, d)).astype(np.float16)
            for _ in range(2))
    fn = lambda q, k, v: jfa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, block_q=32, block_k=32, interpret=True)
    o_j, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o_t = tfa.flash_attention(tq, tk, tv, causal=causal)
    o_t.backward(torch.from_numpy(do))
    assert o_t.dtype == torch.float16 and tq.grad.dtype == torch.float16
    np.testing.assert_allclose(o_t.detach().float().numpy(),
                               np.asarray(o_j, np.float32), atol=4e-3,
                               rtol=4e-3)
    for name, g_t, g_j in zip("qkv", (tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(g_t.float().numpy(),
                                   np.asarray(g_j, np.float32), atol=2e-2,
                                   rtol=2e-2, err_msg=f"d{name}")


def test_flash_fp16_tiled_models_match_plain():
    """The float16 backward kernels' plain models (dS and P rounded to
    float16 per tile) against the untiled plain backward."""
    rng = np.random.default_rng(9)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 96, 64)).astype(
        np.float16)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 96, 64)).astype(
        np.float16)) for _ in range(2))
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    want_dq = tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, True)
    want_dk, want_dv = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta, True)
    got_dq = tfa.flash_attention_bwd_dq_tiled_plain(q, k, v, do, lse, delta,
                                                    True)
    got_dk, got_dv = tfa.flash_attention_bwd_dkv_tiled_plain(
        q, k, v, do, lse, delta, True)
    for got, want in ((got_dq, want_dq), (got_dk, want_dk),
                      (got_dv, want_dv)):
        assert got.dtype == torch.float16
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    assert tfa.bwd_route(torch.float16) == "wgmma"


def test_flash_fp16_wrappers_refuse_the_layout_gate():
    """float16 CUDA tensors take the wgmma kernels ungated; the gated
    (``layout=``) kernels stay float32 / bfloat16 (checked before any
    launch, on every device)."""
    assert tfa._DTYPE_CODES[torch.float16] == 1
    q = torch.zeros(1, 1, 64, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="layout gate runs in float32"):
        tfa._check_cuda("fwd", q, q, q, gated=True)


def test_fp16_streamed_engine_matches_jax():
    """``offload_param`` with fp16: the streamed blocks' gradients are
    scaled on the host and checked there too (``engine.py:1468-1489``);
    the overflow / scale / skip sequence equals the JAX streaming
    engine's step for step through the boundary, the losses within
    1e-2."""
    conf = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "fp16": {"enabled": True, "initial_scale_power": 21,
                     "hysteresis": 1},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "gradient_clipping": 0.5, "steps_per_print": 100,
            "zero_optimization": {"stage": 0,
                                  "offload_optimizer": {"device": "cpu"},
                                  "offload_param": {"device": "cpu"}}}
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.build(jgpt2.GPT2Config.tiny()), config=conf)
    start = jax.device_get(jeng.state["params"])
    start["blocks"] = jeng._param_store.master_blocks()
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.build(tgpt2.GPT2Config.tiny()), config=conf,
        model_parameters=tgpt2.params_from_jax(start), device="cpu")
    ids = np.random.default_rng(2).integers(0, 512, (16, 33)).astype(np.int32)
    got, want = [], []
    for _ in range(6):
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        want.append((bool(jm["overflow"]), float(jm["loss_scale"]),
                     int(jm["skipped"])))
        got.append((bool(tm["overflow"]), tm["loss_scale"], tm["skipped"]))
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-2)
    print("streamed fp16 (overflow, scale, skipped) by step:", got)
    assert got == want
    assert any(ov for ov, _, _ in want) and not all(ov for ov, _, _ in want)
