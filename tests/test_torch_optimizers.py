"""The port's LAMB, SGD (momentum, Nesterov), Adagrad and Lion
(``deepspeed_tpu_torch/ops/optimizers.py``) against the JAX package's optax
chains (``deepspeed_tpu/ops/optimizers.py``) on the CPU.

Each is held to optax within 1e-6 (atol and rtol) over 5 steps with weight
decay, on the same float32 parameters and gradients: the same arithmetic
up to rounding (optax's float32 bias correction included).  Through the
engines, the same config runs ``initialize`` -> ``train_batch`` in both
packages from the same weights, the 3-step losses within 2e-4 as
``tests/test_torch_train.py`` holds AdamW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import optimizers as topt

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)

#: (id, config name, params): every optimizer with weight decay
CASES = [
    ("lamb", "lamb", dict(lr=1e-2, weight_decay=0.01)),
    ("lamb-clamp", "fusedlamb", dict(lr=1e-2, weight_decay=0.1,
                                     betas=(0.8, 0.95), min_coeff=0.05,
                                     max_coeff=0.2)),
    ("sgd", "sgd", dict(lr=1e-2, weight_decay=0.01)),
    ("sgd-momentum", "sgd", dict(lr=1e-2, momentum=0.9, weight_decay=0.01)),
    ("sgd-nesterov", "sgd", dict(lr=1e-2, momentum=0.9, nesterov=True,
                                 weight_decay=0.01)),
    ("adagrad", "adagrad", dict(lr=1e-2, weight_decay=0.01)),
    ("lion", "lion", dict(lr=1e-3, betas=(0.9, 0.99), weight_decay=0.01)),
]


def _problem(seed, steps=5):
    rng = np.random.default_rng(seed)
    shapes = [(7, 5), (13,), (3, 4, 2), (1,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params[-1][:] = 0.0        # a zero leaf: LAMB's neutral trust ratio
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("name,kind,kw", CASES, ids=[c[0] for c in CASES])
def test_optimizer_matches_optax(name, kind, kw, schedule):
    params, grads = _problem(len(name))
    kw = dict(kw)
    lr_schedule = None
    if schedule:
        base = kw.pop("lr")
        lr_schedule = (lambda step: base * (step + 1) / 5)  # noqa: E731
    tx = jopt.get_optimizer(kind, kw, lr_schedule=lr_schedule)
    opt = topt.get_optimizer(kind, kw, lr_schedule=lr_schedule)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for step, g in enumerate(grads):
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        lr = opt.step(tp, [torch.from_numpy(x.copy()) for x in g], tstate)
        assert tstate.count == step + 1
        if schedule:
            assert lr == pytest.approx(lr_schedule(step))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"step {step}", **TOL)


def test_optimizer_states_and_refusals():
    """Each state carries optax's buffers (SGD without momentum none); the
    1-bit optimizers stay refused, naming Queue A 8."""
    p = [torch.zeros(3)]
    assert topt.state_buffers(topt.FusedLamb().init(p)) == ["mu", "nu"]
    assert topt.SGD(momentum=0.0).init(p).trace == []
    assert topt.state_buffers(topt.SGD(momentum=0.9).init(p)) == ["trace"]
    sos = topt.Adagrad().init(p).sum_of_squares
    assert torch.equal(sos[0], torch.full((3,), 0.1))
    assert topt.state_buffers(topt.Lion().init(p)) == ["mu"]
    for name in ("onebitadam", "onebitlamb", "zerooneadam"):
        with pytest.raises(NotImplementedError, match="Queue A 8"):
            topt.get_optimizer(name, {})
    with pytest.raises(ValueError, match="min_coeff"):
        topt.FusedLamb(min_coeff=0.5, max_coeff=0.1)


ENGINE_CASES = [("Lamb", {"lr": 2e-3, "weight_decay": 0.01}),
                ("SGD", {"lr": 5e-2, "momentum": 0.9, "nesterov": True}),
                ("Adagrad", {"lr": 2e-2}),
                ("Lion", {"lr": 2e-4, "weight_decay": 0.1})]


@pytest.mark.parametrize("opt_type,params", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_engines_train_with_each_optimizer(opt_type, params, tmp_path):
    """``initialize`` -> ``train_batch`` with the optimizer in the config,
    both engines from the same weights: 3 steps within 2e-4; a checkpoint
    of the port's engine carries the optimizer's own buffers and resumes
    with the same bits."""
    cfg, tcfg = jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()
    conf = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "optimizer": {"type": opt_type, "params": params},
            "gradient_clipping": 1.0, "steps_per_print": 100}
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=jgpt2.build(cfg), config=conf)
    start = tgpt2.params_from_jax(jax.device_get(jeng.state["params"]))

    def engine():
        return deepspeed_tpu_torch.initialize(
            model=tgpt2.build(tcfg), config=conf, device="cpu",
            model_parameters=start)[0]

    teng = engine()
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, cfg.vocab_size, (16, 17)).astype(np.int32)
               for _ in range(4)]
    for ids in batches[:3]:
        _, jm = jeng.train_batch({"input_ids": ids})
        _, tm = teng.train_batch({"input_ids": ids})
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=2e-4)
    teng.save_checkpoint(str(tmp_path))
    other = engine()
    other.load_checkpoint(str(tmp_path))
    a = teng.train_batch({"input_ids": batches[3]})[1]["loss"]
    b = other.train_batch({"input_ids": batches[3]})[1]["loss"]
    assert a == b
    for x, y in zip(teng._leaves, other._leaves):
        assert torch.equal(x, y)
