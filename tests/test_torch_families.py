"""The PyTorch port's GPT-NeoX, GPT-J and GPT-Neo families
(``deepspeed_tpu_torch/models/{gptneox,gptj,gptneo}.py``) against the JAX
package's, on the CPU at fp32, one parametrised case a family variant:
GPT-NeoX with the parallel and the sequential residual, GPT-J, and
GPT-Neo with a local layer whose window (8) is shorter than the prompt.

 - ``forward`` logits and the loss within 1e-4;
 - ``forward_cached`` (a prefill at position 0, then single-token steps
   over the contiguous cache) within 1e-4;
 - greedy ``generate`` token-exact against the JAX engine;
 - at hidden 128 (whole k-groups): the w8a8 records bit for bit and w8a8
   ``generate`` token-exact against the JAX engine;
 - the named configs equal to JAX's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gptj as jgptj
from deepspeed_tpu.models import gptneo as jgptneo
from deepspeed_tpu.models import gptneox as jgptneox
from deepspeed_tpu_torch.models import gptj as tgptj
from deepspeed_tpu_torch.models import gptneo as tgptneo
from deepspeed_tpu_torch.models import gptneox as tgptneox
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
#: variant -> (JAX module, port module, config class name, overrides)
VARIANTS = {
    "neox_parallel": (jgptneox, tgptneox, "GPTNeoXConfig", {}),
    "neox_sequential": (jgptneox, tgptneox, "GPTNeoXConfig",
                        dict(use_parallel_residual=False)),
    "gptj": (jgptj, tgptj, "GPTJConfig", {}),
    "gptneo_local": (jgptneo, tgptneo, "GPTNeoConfig", {}),
}
NAMES = list(VARIANTS)
#: hidden 128 (one k-group of 128, 128-column N): every matrix quantizes
WIDE = dict(num_heads=2, hidden_size=128)
#: the JAX and port named configs, by family
NAMED = [("GPTNeoXConfig", "neox_20b", jgptneox, tgptneox),
         ("GPTNeoXConfig", "pythia_160m", jgptneox, tgptneox),
         ("GPTJConfig", "gptj_6b", jgptj, tgptj),
         ("GPTNeoConfig", "neo_1p3b", jgptneo, tgptneo),
         ("GPTNeoConfig", "neo_2p7b", jgptneo, tgptneo)]


def _configs(name, wide=False):
    jmod, tmod, cls, kw = VARIANTS[name]
    kw = {**kw, **(WIDE if wide else {})}
    return (jmod, tmod, dataclasses.replace(getattr(jmod, cls).tiny(), **kw),
            dataclasses.replace(getattr(tmod, cls).tiny(), **kw))


@functools.lru_cache(maxsize=None)
def _weights(name, wide=False):
    """(JAX module, port module, JAX config, port config, JAX params as
    numpy, port params): the JAX initializer's shapes drawn with numpy
    from a seed (biases and LN parameters nonzero)."""
    jmod, tmod, jcfg, tcfg = _configs(name, wide)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jmod.init_params(jcfg, key),
                            jax.random.PRNGKey(0))

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                ((1.0 if "scale" in k else 0.0) +
                 (0.1 if ("scale" in k or "_b" in k) else 0.05) *
                 rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    jp = draw(shapes)
    return jmod, tmod, jcfg, tcfg, jp, tmod.params_from_jax(jp)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_jax(name):
    jmod, tmod, jcfg, tcfg, jp, tp = _weights(name)
    assert set(tp) == set(jp)
    assert set(tp["blocks"]) == set(jp["blocks"])
    ids = np.random.default_rng(1).integers(0, 512, (2, 12))
    want = np.asarray(jmod.forward(jcfg, jp, jnp.asarray(ids)))
    np.testing.assert_allclose(tmod.forward(tcfg, tp, _t(ids)).numpy(),
                               want, **TOL)
    labels = ids[:, 1:].copy()
    labels[1, :4] = -100
    jloss = jmod.loss_from_batch(jcfg, jp, (jnp.asarray(ids[:, :-1]),
                                            jnp.asarray(labels)))
    tloss = tmod.loss_from_batch(tcfg, tp, (_t(ids[:, :-1]), _t(labels)))
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_forward_cached_matches_jax(name):
    jmod, tmod, jcfg, tcfg, jp, tp = _weights(name)
    ids = np.random.default_rng(2).integers(0, 512, (2, 12))
    jc = jmod.init_cache(jcfg, 2, 32, jnp.float32)
    tc = tmod.init_cache(tcfg, 2, 32, torch.float32)
    jl, jc = jmod.forward_cached(jcfg, jp, jnp.asarray(ids), jc, 0)
    tl, tc = tmod.forward_cached(tcfg, tp, _t(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for pos in range(12, 16):
        nxt = np.asarray(jl).argmax(-1)[:, None]
        jl, jc = jmod.forward_cached(jcfg, jp, jnp.asarray(nxt), jc, pos)
        tl, tc = tmod.forward_cached(tcfg, tp, _t(nxt), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def _engines(name, wide=False, quant=False):
    jmod, tmod, jcfg, tcfg, jp, tp = _weights(name, wide)
    config = {"dtype": "fp32"}
    if quant:
        config["quant"] = {"enabled": True, "type": "w8a8"}
    deepspeed_tpu.comm.reset_topology()
    jeng = deepspeed_tpu.init_inference(jmod.build(jcfg), config=config,
                                        params=jp)
    teng = deepspeed_tpu_torch.init_inference(tmod.build(tcfg),
                                              config=config, params=tp,
                                              device="cpu")
    return jeng, teng


@pytest.mark.parametrize("name", NAMES)
def test_generate_token_exact_with_jax(name):
    jeng, teng = _engines(name)
    prompts = np.random.default_rng(5).integers(0, 512, (2, 13))
    want = np.asarray(jeng.generate(prompts, max_new_tokens=8))
    np.testing.assert_array_equal(
        teng.generate(prompts, max_new_tokens=8), want)


@pytest.mark.parametrize("name", ["neox_parallel", "gptj", "gptneo_local"])
def test_w8a8_records_and_generate_token_exact_with_jax(name):
    jeng, teng = _engines(name, wide=True, quant=True)
    tb = teng.params["blocks"]
    jb = jax.device_get(jeng.params["blocks"])
    quantized = []
    for key, leaf in tb.items():
        if tq.is_k_quantized(leaf):
            quantized.append(key)
            for k in ("qk", "kscale"):
                np.testing.assert_array_equal(leaf[k].numpy(),
                                              np.asarray(jb[key][k]))
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jb[key]))
    assert {"o_w", "fc_w", "proj_w"} <= set(quantized), quantized
    prompts = np.random.default_rng(6).integers(0, 512, (2, 10))
    want = np.asarray(jeng.generate(prompts, max_new_tokens=6))
    np.testing.assert_array_equal(
        teng.generate(prompts, max_new_tokens=6), want)


@pytest.mark.parametrize("cls,fn,jmod,tmod", NAMED,
                         ids=[c[1] for c in NAMED])
def test_named_configs_match_jax(cls, fn, jmod, tmod):
    j, t = getattr(getattr(jmod, cls), fn)(), getattr(getattr(tmod, cls), fn)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t), fn
    assert j.num_params() == t.num_params(), fn
    model = tmod.build(t)
    assert model.decode_hooks["max_seq_len"] == t.max_seq_len
    assert model.model_config is t and model.quant_aware


@pytest.mark.parametrize("name", NAMES)
def test_random_draws_have_the_jax_shapes(name):
    """The port's layer-by-layer draw (bf16 on the generator's device)
    gives the JAX initializer's tree and shapes, unit LN scales and zero
    biases."""
    jmod, tmod, jcfg, tcfg = _configs(name)
    shapes = jax.eval_shape(lambda key: jmod.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    mine = tmod.init_params(tcfg, torch.Generator().manual_seed(1),
                            dtype=torch.bfloat16)
    assert set(mine) == set(shapes)
    for k, leaf in mine["blocks"].items():
        assert tuple(leaf.shape) == shapes["blocks"][k].shape, k
        assert leaf.dtype == torch.bfloat16, k
    assert torch.all(mine["blocks"]["ln1_scale"] == 1)
    assert torch.all(mine["blocks"]["fc_b"] == 0)
