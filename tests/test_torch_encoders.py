"""The PyTorch port's encoder families (``models/bert.py``, DistilBERT
through its injection policy, ``models/clip.py``) against the JAX package
and HuggingFace ``transformers`` on the CPU, at ``tiny()``.

The same weights (numpy arrays in the JAX layout) and inputs go through
both packages.  Tolerances, fp32: MLM and similarity logits 1e-4, losses
1e-5, gradients 1e-4; the 3-step engine trajectories rtol 2e-4 (the
weights after as ``_assert_adam_weights`` says).  bf16
lane: the port's MLM argmax agrees with JAX's bf16 on >= 0.95 of the
positions, and CLIP's bf16 similarity logits are within a relative RMSE of
2e-2 of JAX's bf16 (both against the same bf16 weights).  HF ingestion:
tiny random ``BertForMaskedLM``, ``DistilBertForMaskedLM`` and
``CLIPModel`` built from their configs (no download): the port's tree
equals the JAX ``replace_module``'s leaf for leaf, and the logits equal
HF's within 1e-4.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import clip as jclip
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import clip as tclip
from deepspeed_tpu_torch.module_inject import replace_policy as tpol
from deepspeed_tpu_torch.runtime.state_dict_factory import write_safetensors

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
#: CLIP's eos id inside the tiny vocabulary
EOS = 95
FAMILIES = {"bert": (jbert, tbert, jbert.BertConfig.tiny,
                     tbert.BertConfig.tiny),
            "clip": (jclip, tclip, jclip.CLIPConfig.tiny,
                     tclip.CLIPConfig.tiny)}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_trees(got, want, exact=False, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, leaf in want.items():
        if exact:
            np.testing.assert_array_equal(_np(got[path]), _np(leaf),
                                          err_msg=str(path))
        else:
            np.testing.assert_allclose(_np(got[path]), _np(leaf),
                                       err_msg=str(path), **tol)


def _batch(name, rng, b=2):
    """A training batch of the family's keys (BERT: 15% of the positions
    labelled, the second row padded past 10; CLIP: each text row with its
    eos)."""
    if name == "bert":
        ids = rng.integers(0, 512, (b, 16))
        mask = np.ones((b, 16), np.int32)
        mask[1::2, 10:] = 0
        labels = np.where(rng.random((b, 16)) < 0.15, ids, -100)
        labels[0, 3] = ids[0, 3]
        return {"input_ids": ids, "attention_mask": mask, "labels": labels}
    ids = rng.integers(0, EOS, (b, 16))
    ids[np.arange(b), rng.integers(4, 16, (b,))] = EOS
    return {"input_ids": ids,
            "pixel_values": rng.standard_normal((b, 3, 32, 32)).astype(
                np.float32)}


def _tbatch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    name = request.param
    jmod, tmod, jcfg, tcfg = FAMILIES[name]
    jcfg, tcfg = jcfg(), tcfg()
    if name == "clip":
        jcfg.eos_token_id = tcfg.eos_token_id = EOS
    weights = _numpy(tmod.init_params(tcfg, torch.Generator().manual_seed(3)))
    return name, jmod, tmod, jcfg, tcfg, weights


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad


# --------------------------------------------------------------- the models
def test_forward_loss_and_grads_match_jax(family):
    name, jmod, tmod, jcfg, tcfg, jparams = family
    batch = _batch(name, np.random.default_rng(1))
    want = jax.jit(jmod.build(jcfg).apply_fn)(jparams, batch)
    params = tmod.params_from_jax(jparams)
    got = tmod.build(tcfg).apply_fn(params, _tbatch(batch))
    if name == "clip":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **TOL)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_from_batch(jcfg, p, batch)))(jparams)
    for _, p in _leaves(params):
        p.requires_grad_()
    tloss = tmod.loss_from_batch(tcfg, params, _tbatch(batch))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_trees(_grads(params), jax.device_get(jgrads), **TOL)


def _assert_adam_weights(got, want, lr, steps):
    """The weights after ``steps`` Adam steps of both engines.  Adam moves
    an element by up to ``lr`` a step whatever its gradient's size, so an
    element whose gradient crosses zero takes a step of rounding noise,
    differently in each package: every element within ``steps x lr``, and
    all but 0.5% of a leaf's elements within rtol 2e-4 / atol 2e-5 (a leaf
    whose gradient differed would move most of its elements).  A key bias
    (the VAE's single-head attention) is all noise: it shifts every score
    of a query alike, so the softmax cancels its gradient; it is held to
    the first bound alone."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, leaf in want.items():
        g, w = _np(got[path]), _np(leaf)
        assert np.abs(g - w).max() <= steps * lr, path
        if path[-2:] == ("k", "b"):
            continue
        off = np.abs(g - w) > 2e-5 + 2e-4 * np.abs(w)
        assert off.mean() <= 5e-3, (path, off.mean())


def _given(spec, weights):
    """The JAX model with ``weights`` as its initializer's result: the JAX
    engine takes no initial parameters, and compiling the family's random
    init costs ~10 s on the CPU."""
    import dataclasses

    return dataclasses.replace(spec, init_fn=lambda rng: jax.tree_util.
                               tree_map(jnp.asarray, weights))


def test_engine_trajectory_matches_jax(family):
    """Three ``train_batch`` steps of both engines from the same weights:
    loss and grad norm a step, the weights after."""
    name, jmod, tmod, jcfg, tcfg, jparams = family
    conf = {"train_batch_size": 8, "seed": 9,
            "optimizer": {"type": "Adam", "params": {"lr": 2e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 100}
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=_given(jmod.build(jcfg),
                                                     jparams), config=conf)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tmod.build(tcfg), config=conf,
        model_parameters=tmod.params_from_jax(jparams), device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = _batch(name, rng, b=8)
        _, jm = jeng.train_batch(batch)
        _, tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=2e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=2e-4)
    _assert_adam_weights(teng.params, jax.device_get(jeng.state["params"]),
                         2e-3, 3)


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  tree)


def test_bf16_lane_agrees_with_jax(family):
    """The same bf16 weights in both packages: BERT's MLM argmax agrees on
    >= 0.95 of the positions, CLIP's similarity logits within a relative
    RMSE of 2e-2 (the scores are rounded to bf16 before the f32 mask and
    softmax in both)."""
    name, jmod, tmod, jcfg, tcfg, jparams = family
    batch = _batch(name, np.random.default_rng(2), b=4)
    jp = _bf16(jparams)
    want = jax.jit(jmod.build(jcfg).apply_fn)(jp, batch)
    params = tmod.params_from_jax(jax.device_get(jp))
    got = tmod.build(tcfg).apply_fn(params, _tbatch(batch))
    if name == "bert":
        agree = (got.float().argmax(-1).numpy() ==
                 np.asarray(want.astype(jnp.float32)).argmax(-1)).mean()
        assert agree >= 0.95, agree
        return
    g, w = got[1].numpy(), np.asarray(want[1], np.float32)
    rel = np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2))
    assert rel <= 2e-2, rel


def test_bert_padding_mask():
    """A position whose ``attention_mask`` is 0 is seen by no query: its
    token changes no unmasked position's logits (and JAX agrees)."""
    cfg = tbert.BertConfig.tiny()
    params = tbert.init_params(cfg, torch.Generator().manual_seed(5))
    batch = _batch("bert", np.random.default_rng(3))
    other = dict(batch, input_ids=batch["input_ids"].copy())
    other["input_ids"][1, 10:] = (other["input_ids"][1, 10:] + 7) % 512
    a = tbert.apply(cfg, params, _tbatch(batch)).detach()
    b = tbert.apply(cfg, params, _tbatch(other)).detach()
    np.testing.assert_array_equal(a[1, :10].numpy(), b[1, :10].numpy())
    assert not torch.equal(a[1, 10:], b[1, 10:])
    want = jbert.forward(jbert.BertConfig.tiny(), _numpy(params),
                         jnp.asarray(other["input_ids"]),
                         jnp.asarray(other["attention_mask"]))
    np.testing.assert_allclose(b.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eos", [EOS, None])
def test_clip_text_pooling(eos):
    """The text tower pools the first ``eos_token_id`` (of two: the first),
    or the argmax of the ids when the config has none."""
    tcfg, jcfg = tclip.CLIPConfig.tiny(), jclip.CLIPConfig.tiny()
    tcfg.eos_token_id = jcfg.eos_token_id = eos
    ids = np.array([[5, 90, 7, 93, 1], [94, 3, 2, 1, 0], [9, 9, 9, 9, 9]])
    ids[0, [1, 3]] = [EOS, EOS] if eos is not None else [90, 93]
    want_pos = [1, 0, 0] if eos is not None else [3, 0, 0]
    assert tclip.pool_positions(tcfg, torch.tensor(ids)).tolist() == \
        want_pos
    params = tclip.init_params(tcfg, torch.Generator().manual_seed(6))
    got = tclip.encode_text(tcfg, params, torch.tensor(ids)).detach()
    want = jclip.encode_text(jcfg, _numpy(params), jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_inference_forward_matches_jax(family):
    """``init_inference(model).forward(dict batch)`` equals the JAX
    engine's on the same weights; ``generate`` refuses."""
    name, jmod, tmod, jcfg, tcfg, jparams = family
    batch = _batch(name, np.random.default_rng(7))
    batch.pop("labels", None)
    deepspeed_tpu.comm.reset_topology()
    want = deepspeed_tpu.init_inference(
        jmod.build(jcfg), config={"dtype": "fp32"},
        params=jparams).forward(batch)
    engine = deepspeed_tpu_torch.init_inference(
        tmod.build(tcfg), config={"dtype": "fp32"},
        params=tmod.params_from_jax(jparams), device="cpu")
    got = engine.forward(batch)
    for g, w in (zip(got, want) if name == "clip" else [(got, want)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(NotImplementedError, match="no decode_hooks"):
        engine.generate(batch["input_ids"], max_new_tokens=1)


# --------------------------------------------------------------- HF models
@pytest.fixture(scope="module")
def transformers():
    return pytest.importorskip("transformers")


HF = {
    "bert": ("BertConfig", "BertForMaskedLM",
             dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=32, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)),
    "distilbert": ("DistilBertConfig", "DistilBertForMaskedLM",
                   dict(vocab_size=96, dim=32, n_layers=2, n_heads=4,
                        hidden_dim=64, max_position_embeddings=32,
                        dropout=0.0, attention_dropout=0.0)),
    "clip": ("CLIPConfig", "CLIPModel",
             dict(text_config=dict(vocab_size=96, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4,
                                   max_position_embeddings=16,
                                   eos_token_id=EOS),
                  vision_config=dict(hidden_size=48, intermediate_size=96,
                                     num_hidden_layers=2,
                                     num_attention_heads=4, image_size=32,
                                     patch_size=16),
                  projection_dim=24)),
}


def _hf_model(transformers, arch, seed=0):
    cfg_cls, model_cls, kw = HF[arch]
    torch.manual_seed(seed)
    with torch.no_grad():
        model = getattr(transformers, model_cls)(
            getattr(transformers, cfg_cls)(**kw))
        for _, p in model.named_parameters():
            if p.ndim == 1:   # random biases and norms
                p.add_(0.05 * torch.randn_like(p))
    return model.eval()


def _hf_inputs(arch):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, EOS, (2, 12))
    ids[:, 9] = EOS
    if arch == "clip":
        return {"input_ids": ids, "pixel_values": rng.standard_normal(
            (2, 3, 32, 32)).astype(np.float32)}
    mask = np.ones((2, 12), np.int64)
    mask[1, 8:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _hf_logits(hf, arch, inputs):
    with torch.no_grad():
        out = hf(**{k: torch.as_tensor(v) for k, v in inputs.items()})
    return out.logits_per_text.numpy() if arch == "clip" else \
        out.logits.numpy()


def _port_logits(model, params, arch, inputs):
    with torch.no_grad():
        out = model.apply_fn(params, _tbatch(inputs))
    return (out[1] if arch == "clip" else out).numpy()


@pytest.mark.parametrize("arch", list(HF))
def test_hf_models_convert_as_jax_and_match_hf(transformers, arch, tmp_path):
    """``replace_module`` of a HF model: the port's tree equals the JAX
    policy's leaf for leaf, its logits HF's; the same from the
    ``config.json`` dict, and through ``init_inference(directory)`` of a
    ``config.json`` + ``model.safetensors`` the port writes."""
    hf = _hf_model(transformers, arch)
    model, params = deepspeed_tpu_torch.replace_module(hf_model=hf)
    _, jparams = deepspeed_tpu.module_inject.replace_module(hf_model=hf)
    _assert_trees(params, jax.device_get(jparams), exact=True)
    inputs = _hf_inputs(arch)
    np.testing.assert_allclose(_port_logits(model, params, arch, inputs),
                               _hf_logits(hf, arch, inputs), **TOL)
    cfg = json.loads(hf.config.to_json_string())
    _, again = tpol.replace_module(config=cfg, state_dict=hf.state_dict())
    _assert_trees(again, params, exact=True)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    write_safetensors({k: v.contiguous() for k, v in hf.state_dict().items()},
                      str(tmp_path / "model.safetensors"))
    engine = deepspeed_tpu_torch.init_inference(
        str(tmp_path), config={"dtype": "fp32"}, device="cpu")
    got = engine.forward(inputs)
    np.testing.assert_array_equal(
        (got[1] if arch == "clip" else got).numpy(),
        _port_logits(model, params, arch, inputs))


def test_distilbert_refusals_keep_jax_messages(transformers):
    """An untied ``vocab_projector`` and a non-GELU activation are refused
    with the JAX policy's messages."""
    hf = _hf_model(transformers, "distilbert")
    sd = dict(hf.state_dict())
    sd["vocab_projector.weight"] = sd["vocab_projector.weight"] + 1.0
    cfg = json.loads(hf.config.to_json_string())
    with pytest.raises(NotImplementedError, match="untied vocab_projector"):
        tpol.replace_module(config=cfg, state_dict=sd)
    with pytest.raises(NotImplementedError, match="activation='relu'"):
        tpol.replace_module(config=dict(cfg, activation="relu"),
                            state_dict=hf.state_dict())
