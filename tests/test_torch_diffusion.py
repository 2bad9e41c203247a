"""The PyTorch port's diffusion families (``models/vae.py``,
``models/unet.py``) against the JAX package on the CPU, at ``tiny()``.

The same JAX-initialised weights (``params_from_jax``) and numpy inputs go
through both packages.  Tolerances, fp32: forward outputs 1e-4, losses
1e-5, gradients 1e-4 (summation orders of small convolutions); the 3-step
engine trajectories rtol 2e-4, as the GPT-2 trajectory's (the weights
after as ``_assert_adam_weights`` says).  ``ops.sampling.
normal`` is held to ``jax.random.normal`` within 1e-6 (XLA's ``erf_inv``
polynomial; torch's ``log1p`` may round one ulp otherwise), its uniform
bits exactly.  ``tests/conftest.py`` gives JAX 8 CPU devices, so the JAX
engines split each micro-batch over dp=8: both engines get the same
``train_batch_size``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import unet as junet
from deepspeed_tpu.models import vae as jvae
from deepspeed_tpu_torch.models import unet as tunet
from deepspeed_tpu_torch.models import vae as tvae
from deepspeed_tpu_torch.ops import sampling

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = {"vae": (jvae, tvae, jvae.VAEConfig.tiny, tvae.VAEConfig.tiny),
            "unet": (junet, tunet, junet.UNetConfig.tiny,
                     tunet.UNetConfig.tiny)}


def _batch(family, rng, b=2, h=32, w=24):
    """A training batch of the family's keys, and its inference batch."""
    if family == "vae":
        x = (0.5 * rng.standard_normal((b, 3, h, w))).astype(np.float32)
        return {"pixel_values": x}, {"pixel_values": x}
    lat = rng.standard_normal((b, 4, h // 2, w // 2)).astype(np.float32)
    train = {"noisy_latents": lat,
             "noise": rng.standard_normal(lat.shape).astype(np.float32),
             "timesteps": rng.integers(0, 1000, (b,)).astype(np.int32),
             "encoder_hidden_states": rng.standard_normal(
                 (b, 7, 24)).astype(np.float32)}
    return train, {"sample": lat, "timesteps": train["timesteps"],
                   "encoder_hidden_states": train["encoder_hidden_states"]}


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, path + (i,))
    else:
        yield path, tree


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _assert_trees(got, want, exact=False, **tol):
    got, want = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    assert set(got) == set(want)
    for path, leaf in want.items():
        if exact:
            np.testing.assert_array_equal(_np(got[path]), _np(leaf),
                                          err_msg=str(path))
        else:
            np.testing.assert_allclose(_np(got[path]), _np(leaf),
                                       err_msg=str(path), **tol)


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _weights(tmod, tcfg, seed):
    """Random weights in the JAX layout as numpy arrays, drawn by the
    port's initializer (JAX's eager ``init_params`` of a tiny UNet takes
    ~20 s on the CPU); both packages then get the same numbers."""
    return _numpy(tmod.init_params(tcfg, torch.Generator().manual_seed(seed)))


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    name = request.param
    jmod, tmod, jcfg, tcfg = FAMILIES[name]
    return name, jmod, tmod, jcfg(), tcfg(), _weights(tmod, tcfg(), 3)


# ----------------------------------------------------------------- sampling
@pytest.mark.parametrize("seed,shape", [(0, (2, 4, 16, 16)), (7, (4097,)),
                                        (123456789, (3, 5))])
def test_normal_matches_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    words = torch.tensor(np.asarray(jax.random.key_data(key)),
                         dtype=torch.int64)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(
        sampling.uniform(words, shape, lo, 1.0).numpy(),
        np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0)))
    got = sampling.normal(words, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.random.normal(key, shape)),
                               rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- the models
def test_forward_loss_and_grads_match_jax(family):
    name, jmod, tmod, jcfg, tcfg, jparams = family
    train, infer = _batch(name, np.random.default_rng(1))
    want = np.asarray(jax.jit(jmod.build(jcfg).apply_fn)(jparams, infer))
    params = tmod.params_from_jax(jparams)
    got = tmod.build(tcfg).apply_fn(params, _torch_batch(infer))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_from_batch(jcfg, p, train, rng=None,
                                       train=False)))(jparams)
    leaves = [p.requires_grad_() for _, p in _tree_leaves(params)]
    tloss = tmod.loss_from_batch(tcfg, params, _torch_batch(train), None,
                                 False)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_trees(_grads(params), jax.device_get(jgrads), **TOL)
    assert all(p.grad is not None for p in leaves)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def test_vae_train_loss_with_the_engine_key():
    """The VAE's training loss samples its latent from the micro-step key
    the engine hands it (``sampling.normal`` on the JAX-layout key)."""
    cfg = jvae.VAEConfig.tiny()
    jparams = _weights(tvae, tvae.VAEConfig.tiny(), 3)
    train, _ = _batch("vae", np.random.default_rng(2))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tvae.build(tvae.VAEConfig.tiny()),
        config={"train_batch_size": 2, "seed": 5,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        model_parameters=tvae.params_from_jax(jparams), device="cpu")
    jloss = jax.jit(lambda p, k: jvae.loss_from_batch(cfg, p, train, rng=k,
                                                       train=True))
    for step, micro in ((0, 0), (3, 1)):
        key = engine._micro_rng(micro, step)
        want = jloss(jparams, jnp.asarray(key.numpy(), jnp.uint32))
        got = tvae.loss_from_batch(tvae.VAEConfig.tiny(), engine.params,
                                   _torch_batch(train), key, True)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # the draw moved the loss off the mean latent's
    assert got.item() != tvae.loss_from_batch(
        tvae.VAEConfig.tiny(), engine.params, _torch_batch(train), None,
        False).item()


def _given(spec, weights):
    """The JAX model with ``weights`` as its initializer's result: the JAX
    engine takes no initial parameters, and compiling the family's random
    init costs ~10 s on the CPU."""
    import dataclasses

    return dataclasses.replace(spec, init_fn=lambda rng: jax.tree_util.
                               tree_map(jnp.asarray, weights))


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
    got, want = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    assert set(got) == set(want)
    for path, leaf in want.items():
        g, w = _np(got[path]), _np(leaf)
        assert np.abs(g - w).max() <= steps * lr, path
        if path[-2:] == ("k", "b"):
            continue
        off = np.abs(g - w) > 2e-5 + 2e-4 * np.abs(w)
        assert off.mean() <= 5e-3, (path, off.mean())


def _engine_config(lr):
    return {"train_batch_size": 8, "seed": 9,
            "optimizer": {"type": "Adam", "params": {"lr": lr}},
            "gradient_clipping": 1.0, "steps_per_print": 100}


def test_engine_trajectory_matches_jax(family):
    """Three ``train_batch`` steps of both engines from the same weights:
    loss and grad norm per step, the weights after (the VAE's latents drawn
    from each engine's micro-step key)."""
    name, jmod, tmod, jcfg, tcfg, jparams = family
    conf = _engine_config(2e-3)
    deepspeed_tpu.comm.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(model=_given(jmod.build(jcfg),
                                                     jparams), config=conf)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tmod.build(tcfg), config=conf,
        model_parameters=tmod.params_from_jax(jparams), device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(3):
        train, _ = _batch(name, rng, b=8, h=16, w=16)
        _, jm = jeng.train_batch(train)
        _, tm = teng.train_batch(train)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=2e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=2e-4)
    _assert_adam_weights(teng.params, jax.device_get(jeng.state["params"]),
                         2e-3, 3)


def test_inference_forward_matches_jax_and_refuses_decoding(family):
    """``init_inference(model).forward(dict batch)`` moves every leaf to
    the device and applies the model, as the JAX engine does; a model
    without ``decode_hooks`` refuses ``generate`` and ``init_serving``."""
    name, jmod, tmod, jcfg, tcfg, jparams = family
    _, infer = _batch(name, np.random.default_rng(5))
    deepspeed_tpu.comm.reset_topology()
    want = deepspeed_tpu.init_inference(
        jmod.build(jcfg), config={"dtype": "fp32"},
        params=jparams).forward(infer)
    model = tmod.build(tcfg)
    engine = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "fp32"},
        params=tmod.params_from_jax(jparams), device="cpu")
    np.testing.assert_allclose(engine.forward(infer).numpy(),
                               np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError, match="no decode_hooks"):
        engine.generate(np.zeros((1, 4), np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="needs decode_hooks"):
        deepspeed_tpu_torch.init_serving(model, config={"dtype": "fp32"},
                                         device="cpu")
    # random weights drawn by the engine (seed 0) serve too
    out = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bf16"}, device="cpu").forward(infer)
    assert torch.isfinite(out.float()).all()


def test_batch_leaves_keep_their_float_dtype():
    """A bf16 engine casts the weights, never the batch: an f32 latent runs
    f32 convolutions on bf16-rounded weights, a bf16 one bf16 (float64
    arrives as float32, integers as int64)."""
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tvae.build(tvae.VAEConfig.tiny()),
        config={"train_batch_size": 2, "bf16": {"enabled": True}},
        device="cpu")
    moved = engine._to_device({
        "a": np.zeros(2, np.float64), "b": torch.zeros(2, dtype=torch.bfloat16),
        "c": np.zeros(2, np.float32), "t": np.zeros(2, np.int32)})
    assert [moved[k].dtype for k in "abct"] == [
        torch.float32, torch.bfloat16, torch.float32, torch.int64]
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32))
    params = tvae.init_params(tvae.VAEConfig.tiny(),
                              torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        mean, _ = tvae.encode(tvae.VAEConfig.tiny(), _bf16(params),
                              torch.tensor(x, dtype=dtype))
        assert mean.dtype == dtype


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(v) for v in tree]
    return tree.to(torch.bfloat16)


# ------------------------------------------------------------------- layout
def test_downsample_pad_and_nearest_upsample_on_a_non_square_map():
    """The stride-2 down-sampler pads (0, 1) on H and W, not 1 all round,
    and the up-sampler is ``jax.image.resize`` "nearest" at 2x."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 7, 10)).astype(np.float32)
    p = {"w": rng.standard_normal((5, 3, 3, 3)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    hp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, 1), (0, 1)))
    want = jax.lax.conv_general_dilated(
        hp, jnp.asarray(p["w"]), (2, 2), padding=[(0, 0), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW")) + p["b"][None, :, None,
                                                           None]
    tp = {k: torch.tensor(v) for k, v in p.items()}
    got = tvae.downsample(tp, torch.tensor(x))
    assert tuple(got.shape) == (2, 5, 3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    up = {"w": rng.standard_normal((3, 3, 3, 3)).astype(np.float32),
          "b": np.zeros(3, np.float32)}
    jup = jax.image.resize(jnp.asarray(x), (2, 3, 14, 20), "nearest")
    want = jvae.conv2d({k: jnp.asarray(v) for k, v in up.items()}, jup)
    got = tvae.upsample({k: torch.tensor(v) for k, v in up.items()},
                        torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------- HF I/O
def _diffusers_sd(name, params):
    """A diffusers-named state dict made FROM a JAX tree, as
    ``tests/unit/test_vae.py`` and ``test_unet.py`` make theirs."""
    sd = {}

    def conv(n, p):
        sd[n + ".weight"], sd[n + ".bias"] = np.asarray(p["w"]), \
            np.asarray(p["b"])

    def gn(n, p):
        sd[n + ".weight"], sd[n + ".bias"] = np.asarray(p["scale"]), \
            np.asarray(p["bias"])

    def dense(n, p):
        sd[n + ".weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[n + ".bias"] = np.asarray(p["b"])

    def resnet(n, p):
        gn(n + ".norm1", p["norm1"])
        conv(n + ".conv1", p["conv1"])
        gn(n + ".norm2", p["norm2"])
        conv(n + ".conv2", p["conv2"])
        if "time_emb" in p:
            dense(n + ".time_emb_proj", p["time_emb"])
        if "shortcut" in p:
            conv(n + ".conv_shortcut", p["shortcut"])

    def tx(n, p):
        gn(n + ".norm", p["norm"])
        conv(n + ".proj_in", p["proj_in"])
        conv(n + ".proj_out", p["proj_out"])
        b, blk = n + ".transformer_blocks.0", p["block"]
        for i in (1, 2, 3):
            gn(f"{b}.norm{i}", blk[f"ln{i}"])
        for attn in ("attn1", "attn2"):
            for proj in ("q", "k", "v"):
                dense(f"{b}.{attn}.to_{proj}", blk[attn][proj])
            dense(f"{b}.{attn}.to_out.0", blk[attn]["out"])
        dense(b + ".ff.net.0.proj", blk["geglu"])
        dense(b + ".ff.net.2", blk["ff_out"])

    def blocks(prefix, blks, sampler, key):
        for i, blk in enumerate(blks):
            for j, r in enumerate(blk["resnets"]):
                resnet(f"{prefix}.{i}.resnets.{j}", r)
            for j, t in enumerate(blk.get("attns", [])):
                tx(f"{prefix}.{i}.attentions.{j}", t)
            if key in blk:
                conv(f"{prefix}.{i}.{sampler}.0.conv", blk[key])

    if name == "vae":
        for side, kind, sampler, key in (
                ("encoder", "down_blocks", "downsamplers", "down"),
                ("decoder", "up_blocks", "upsamplers", "up")):
            p = params[side]
            conv(side + ".conv_in", p["conv_in"])
            blocks(f"{side}.{kind}", p[key], sampler, key)
            resnet(side + ".mid_block.resnets.0", p["mid"]["res1"])
            resnet(side + ".mid_block.resnets.1", p["mid"]["res2"])
            a, at = side + ".mid_block.attentions.0", p["mid"]["attn"]
            gn(a + ".group_norm", at["norm"])
            for proj, k in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"),
                            ("to_out.0", "proj")):
                dense(f"{a}.{proj}", at[k])
            gn(side + ".conv_norm_out", p["norm_out"])
            conv(side + ".conv_out", p["conv_out"])
        conv("quant_conv", params["quant_conv"])
        conv("post_quant_conv", params["post_quant_conv"])
        return sd
    dense("time_embedding.linear_1", params["time_mlp1"])
    dense("time_embedding.linear_2", params["time_mlp2"])
    conv("conv_in", params["conv_in"])
    blocks("down_blocks", params["down"], "downsamplers", "down")
    resnet("mid_block.resnets.0", params["mid"]["res1"])
    tx("mid_block.attentions.0", params["mid"]["attn"])
    resnet("mid_block.resnets.1", params["mid"]["res2"])
    blocks("up_blocks", params["up"], "upsamplers", "up")
    gn("conv_norm_out", params["norm_out"])
    conv("conv_out", params["conv_out"])
    return sd


def test_diffusers_state_dicts_convert_as_jax(family):
    name, jmod, tmod, jcfg, tcfg, jparams = family
    sd = _diffusers_sd(name, jparams)
    got = tmod.from_hf_state_dict(tcfg, {k: torch.tensor(v)
                                         for k, v in sd.items()})
    _assert_trees(got, jax.device_get(jmod.from_hf_state_dict(jcfg, sd)),
                  exact=True)
    _assert_trees(got, jparams, exact=True)


# -------------------------------------------------------------- checkpoints
def test_unet_checkpoint_round_trips_with_the_jax_leaf_names(tmp_path):
    """``save_checkpoint`` names each leaf by its path as orbax names the
    JAX engine's (``down.0.attns.0.block.attn1.q.w``); a fresh engine loads
    the weights and Adam moments bit-identical and trains on identically."""
    jparams = _weights(tunet, tunet.UNetConfig.tiny(), 3)
    conf = _engine_config(1e-3)

    def engine():
        return deepspeed_tpu_torch.initialize(
            model=tunet.build(tunet.UNetConfig.tiny()), config=conf,
            device="cpu")[0]

    rng = np.random.default_rng(8)
    batches = [_batch("unet", rng, b=8, h=16, w=16)[0] for _ in range(4)]
    a = engine()
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path))
    saved = torch.load(tmp_path / "global_step2" / "state" /
                       "model_states.pt")
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(jparams)}
    assert set(saved["params"]) == want
    assert set(saved["opt_state"]["mu"]) == want
    assert "down.0.attns.0.block.attn1.q.w" in want
    b = engine()
    b.load_checkpoint(str(tmp_path))
    assert b.global_steps == 2
    _assert_trees(b.params, a.params, exact=True)
    for x, y in zip(a._opt_state.mu + a._opt_state.nu,
                    b._opt_state.mu + b._opt_state.nu):
        assert torch.equal(x, y)
    for batch in batches[2:]:
        _, ma = a.train_batch(batch)
        _, mb = b.train_batch(batch)
        assert ma["loss"] == mb["loss"]
    _assert_trees(b.params, a.params, exact=True)
