"""The PyTorch port's int8 records (``deepspeed_tpu_torch/ops/
quantization.py``) against the JAX package's (``deepspeed_tpu/ops/
quantization.py``): the same numpy inputs give the same codes and scales
bit for bit, the same group sizes and the same leaf selection on GPT-2
parameters, and records cross between the packages with their dtypes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)


def _np(x):
    """A JAX or torch array as numpy, bfloat16 read as float32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_records_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"int8": torch.int8,
                                "float32": torch.float32,
                                "bfloat16": torch.bfloat16}[
                                    np.asarray(want[k]).dtype.name], k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def _weights(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * scale
    w[..., 0, :] = 0.0                          # an all-zero group / k-group
    return w


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(symmetric, dtype):
    w = _weights((3, 64, 256), 0, 0.05)
    jw = jnp.asarray(w, dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    want = jq.quantize(jw, group_size=128, symmetric=symmetric)
    got = tq.quantize(tw, group_size=128, symmetric=symmetric)
    _assert_records_equal(got, want)
    np.testing.assert_array_equal(
        _np(tq.dequantize(got, torch.float32)),
        _np(jq.dequantize(want, jnp.float32)))
    assert tq.is_quantized(got) and not tq.is_k_quantized(got)
    with pytest.raises(ValueError):
        tq.quantize(tw, group_size=100)


@pytest.mark.parametrize("k_group", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_k_grouped_matches_jax_bit_for_bit(k_group, dtype):
    w = _weights((2, 512, 384), 1, 0.02)
    want = jq.quantize_k_grouped(jnp.asarray(w, dtype), k_group)
    got = tq.quantize_k_grouped(torch.from_numpy(w).to(getattr(torch, dtype)),
                                k_group)
    _assert_records_equal(got, want)
    assert tuple(got["kscale"].shape) == (2, 512 // k_group, 1, 384)
    assert tq.is_k_quantized(got) and tq.is_record(got)
    np.testing.assert_array_equal(
        _np(tq.dequantize_k(got, torch.float32)),
        _np(jq.dequantize_k(want, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 2, 5, 64)) *
         rng.uniform(0.01, 10.0, (3, 2, 5, 1))).astype(np.float32)
    x[1, 0, 2] = 0.0                            # all-zero vector: scale 1
    jc, js = jq.quantize_kv(jnp.asarray(x, dtype))
    tc, ts = tq.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tc.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_np(ts), _np(js))
    assert float(ts[1, 0, 2]) == 1.0 and int(tc[1, 0, 2].abs().sum()) == 0
    for out in (torch.float32, torch.bfloat16):
        jout = jnp.float32 if out == torch.float32 else jnp.bfloat16
        np.testing.assert_array_equal(
            _np(tq.dequantize_kv(tc, ts, out)),
            _np(jq.dequantize_kv(jc, js, jout)))


def test_pick_k_group_matches_jax():
    for k_dim in (64, 96, 128, 768, 2560, 3072, 4096, 5120, 11008):
        for cap in (8, 64, 128, 256, 1024):
            for sm in (1, 2, 3, 4, 8):
                assert tq.pick_k_group(k_dim, cap, sm) == \
                    jq.pick_k_group(k_dim, cap, sm), (k_dim, cap, sm)


@pytest.fixture(scope="module")
def gpt2_params():
    """GPT-2 at hidden 128 (the width at which w8a8 has whole 128-row
    k-groups), JAX-initialised, in both packages."""
    cfg = jgpt2.GPT2Config(vocab_size=512, max_seq_len=64, num_layers=2,
                           num_heads=4, hidden_size=128)
    jp = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, tgpt2.params_from_jax(jp)


def _paths(tree, pred, path=()):
    if pred(tree) or not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_paths(v, pred, path + (k,)))
    return out


@pytest.mark.parametrize("kind", ["weight", "w8a8"])
@pytest.mark.parametrize("subtree", ["blocks", "all"])
def test_quantize_pytree_selects_the_same_leaves(gpt2_params, kind, subtree):
    _, jp, tp = gpt2_params
    jtree, ttree = (jp["blocks"], tp["blocks"]) if subtree == "blocks" \
        else (jp, tp)
    min_ndim = 3 if subtree == "blocks" else 2
    if kind == "w8a8":
        want = jq.quantize_pytree_k_grouped(jtree, k_group=128,
                                            min_ndim=min_ndim)
        got = tq.quantize_pytree_k_grouped(ttree, k_group=128,
                                           min_ndim=min_ndim)
        pred_j, pred_t = jq.is_k_quantized, tq.is_k_quantized
    else:
        want = jq.quantize_pytree(jtree, group_size=128, min_ndim=min_ndim)
        got = tq.quantize_pytree(ttree, group_size=128, min_ndim=min_ndim)
        pred_j, pred_t = jq.is_quantized, tq.is_quantized
    jleaves = _paths(want, pred_j)
    tleaves = _paths(got, pred_t)
    assert set(jleaves) == set(tleaves)
    chosen = sorted(p for p, v in jleaves.items() if pred_j(v))
    assert chosen == sorted(p for p, v in tleaves.items() if pred_t(v))
    assert chosen, "nothing was quantized"
    for p in jleaves:
        if pred_j(jleaves[p]):
            _assert_records_equal(tleaves[p], jleaves[p])
        else:
            np.testing.assert_array_equal(_np(tleaves[p]), _np(jleaves[p]))
    assert tq.quantized_nbytes(got) == jq.quantized_nbytes(want)
    back_j = jq.dequantize_pytree(want, jnp.float32)
    back_t = tq.dequantize_pytree(got, torch.float32)
    for p, v in _paths(back_j, lambda _: False).items():
        np.testing.assert_array_equal(
            _np(_paths(back_t, lambda _: False)[p]), _np(v))


@pytest.mark.parametrize("kind", ["weight", "w8a8"])
def test_engine_records_cross_between_the_packages(gpt2_params, kind):
    """The JAX engine's host-quantized blocks equal the port engine's, and
    go through ``params_from_jax`` with int8 payloads and f32 scales kept;
    the port engine takes them as pre-quantized params of the same kind and
    refuses them under the other kind."""
    cfg, jp, tp = gpt2_params
    tcfg = tgpt2.GPT2Config(vocab_size=512, max_seq_len=64, num_layers=2,
                            num_heads=4, hidden_size=128)
    qconf = {"dtype": "fp32", "quant": {"enabled": True, "type": kind}}
    deepspeed_tpu.comm.reset_topology()
    jeng = deepspeed_tpu.init_inference(
        jgpt2.build(cfg), params=jp,
        config={**qconf, "tensor_parallel": {"tp_size": 1}})
    teng = deepspeed_tpu_torch.init_inference(tgpt2.build(tcfg), params=tp,
                                              config=qconf, device="cpu")
    jblocks = jax.device_get(jeng.params["blocks"])
    crossed = tgpt2.params_from_jax(jblocks)
    pred = jq.is_k_quantized if kind == "w8a8" else jq.is_quantized
    for name, leaf in jblocks.items():
        if pred(leaf):
            _assert_records_equal(crossed[name], leaf)
            _assert_records_equal(teng.params["blocks"][name], leaf)
        else:
            np.testing.assert_array_equal(_np(teng.params["blocks"][name]),
                                          _np(leaf))
    pre = dict(tp, blocks=crossed)
    again = deepspeed_tpu_torch.init_inference(tgpt2.build(tcfg), params=pre,
                                               config=qconf, device="cpu")
    for name, leaf in again.params["blocks"].items():
        if tq.is_record(leaf):
            for k in leaf:
                assert torch.equal(leaf[k], crossed[name][k])
    other = "weight" if kind == "w8a8" else "w8a8"
    with pytest.raises(ValueError, match="pre-quantized"):
        deepspeed_tpu_torch.init_inference(
            tgpt2.build(tcfg), params=pre, device="cpu",
            config={"dtype": "fp32", "quant": {"enabled": True,
                                               "type": other}})


def test_params_from_jax_reads_bfloat16():
    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32), jnp.bfloat16)
    t = tgpt2.params_from_jax({"w": jax.device_get(a)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))
