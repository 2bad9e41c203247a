"""The PyTorch port's GPT-2 (``deepspeed_tpu_torch/models/gpt2.py``) and
``InferenceEngine`` against the JAX package on ``GPT2Config.tiny()``.

The same JAX-initialised weights go through both packages
(``params_from_jax``); logits agree in fp32 within 1e-4 (different
summation orders over a few layers), and greedy ``generate`` is
token-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg = jgpt2.GPT2Config.tiny(max_seq_len=128)
    jparams = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(3)))
    tcfg = tgpt2.GPT2Config.tiny(max_seq_len=128)
    return cfg, tcfg, jparams, tgpt2.params_from_jax(jparams)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_init_params_and_converter_layout(tiny):
    cfg, tcfg, jparams, tparams = tiny
    mine = tgpt2.init_params(tcfg, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        node_t, node_m = tparams, mine
        for k in keys:
            node_t, node_m = node_t[k], node_m[k]
        assert tuple(node_m.shape) == leaf.shape, keys
        assert node_m.dtype == torch.float32
        np.testing.assert_array_equal(node_t.numpy(), leaf)


def test_forward_logits_match_jax(tiny):
    cfg, tcfg, jparams, tparams = tiny
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    want = jgpt2.forward(cfg, jparams, jnp.asarray(ids), train=False)
    got = tgpt2.forward(tcfg, tparams, torch.from_numpy(ids))
    _close(got, want)
    # the nn.Module face computes the same function
    _close(tgpt2.build(tcfg)(tparams, torch.from_numpy(ids)), want)


def _caches(cfg, tcfg, b, s):
    return (jgpt2.init_cache(cfg, b, s, jnp.float32),
            tgpt2.init_cache(tcfg, b, s, torch.float32))


def test_forward_cached_contiguous_modes_match_jax(tiny):
    """Scalar-position prefill + decode, then per-row (``lengths``) decode
    at ragged positions, on the contiguous cache."""
    cfg, tcfg, jparams, tparams = tiny
    rng = np.random.default_rng(1)
    b = 3
    jc, tc = _caches(cfg, tcfg, b, 32)
    ids = rng.integers(0, cfg.vocab_size, (b, 10))
    jl, jc = jgpt2.forward_cached(cfg, jparams, jnp.asarray(ids), jc, 0)
    tl, tc = tgpt2.forward_cached(tcfg, tparams, torch.from_numpy(ids), tc, 0)
    _close(tl, jl)
    for pos in (10, 11):
        tok = rng.integers(0, cfg.vocab_size, (b, 1))
        jl, jc = jgpt2.forward_cached(cfg, jparams, jnp.asarray(tok), jc, pos)
        tl, tc = tgpt2.forward_cached(tcfg, tparams, torch.from_numpy(tok),
                                      tc, pos)
        _close(tl, jl)
    lengths = np.array([12, 5, 20], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (b, 1))
    jl, jc = jgpt2.forward_cached(cfg, jparams, jnp.asarray(tok), jc, 0,
                                  lengths=jnp.asarray(lengths))
    tl, tc = tgpt2.forward_cached(tcfg, tparams, torch.from_numpy(tok), tc, 0,
                                  lengths=torch.from_numpy(lengths))
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key], atol=1e-5)


def test_forward_cached_paged_chunked_prefill_and_decode(tiny):
    """Chunked prefill with per-row bases + valid counts (pads to scratch)
    through block tables, all-position logits, then per-row paged decode."""
    cfg, tcfg, jparams, tparams = tiny
    rng = np.random.default_rng(2)
    b, bs, nbper, nb = 3, 8, 4, 13
    jc, tc = _caches(cfg, tcfg, nb, bs)
    bt = rng.permutation(np.arange(1, nb))[:b * nbper].reshape(b, nbper)
    bt = bt.astype(np.int32)
    bt[2, 3] = 0                                  # unset entry -> scratch
    jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
    width = 8
    for base, valid in (([0, 0, 0], [8, 8, 5]), ([8, 8, 5], [8, 3, 8])):
        base = np.array(base, np.int32)
        valid = np.array(valid, np.int32)
        ids = rng.integers(0, cfg.vocab_size, (b, width))
        jl, jc = jgpt2.forward_cached(cfg, jparams, jnp.asarray(ids), jc,
                                      jnp.asarray(base),
                                      lengths=jnp.asarray(valid),
                                      block_tables=jbt)
        tl, tc = tgpt2.forward_cached(tcfg, tparams, torch.from_numpy(ids),
                                      tc, torch.from_numpy(base),
                                      lengths=torch.from_numpy(valid),
                                      block_tables=tbt)
        _close(tl, jl)
    ja, _ = jgpt2.forward_cached(cfg, jparams, jnp.asarray(ids), jc,
                                 jnp.asarray(base), lengths=jnp.asarray(valid),
                                 block_tables=jbt, all_positions=True)
    ta, _ = tgpt2.forward_cached(tcfg, tparams, torch.from_numpy(ids), tc,
                                 torch.from_numpy(base),
                                 lengths=torch.from_numpy(valid),
                                 block_tables=tbt, all_positions=True)
    assert tuple(ta.shape) == (b, width, cfg.vocab_size)
    _close(ta, ja)
    lengths = base + valid
    tok = rng.integers(0, cfg.vocab_size, (b, 1))
    jl, jc = jgpt2.forward_cached(cfg, jparams, jnp.asarray(tok), jc, 0,
                                  lengths=jnp.asarray(lengths),
                                  block_tables=jbt)
    tl, tc = tgpt2.forward_cached(tcfg, tparams, torch.from_numpy(tok), tc, 0,
                                  lengths=torch.from_numpy(lengths),
                                  block_tables=tbt)
    _close(tl, jl)
    for key in ("k", "v"):                        # scratch block 0 excluded
        _close(tc[key][:, 1:], np.asarray(jc[key])[:, 1:], atol=1e-5)


@pytest.mark.parametrize("use_eos", [False, True])
def test_greedy_generate_token_exact_vs_jax(tiny, use_eos):
    cfg, tcfg, jparams, tparams = tiny
    deepspeed_tpu.comm.reset_topology()
    jeng = deepspeed_tpu.init_inference(
        jgpt2.build(cfg), config={"dtype": "fp32",
                                  "tensor_parallel": {"tp_size": 1}},
        params=jparams)
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tcfg), config={"dtype": "fp32"}, params=tparams,
        device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 12))
    eos = None
    if use_eos:     # a token row 0 emits mid-way: exercises the early exit
        eos = int(teng.generate(prompts, max_new_tokens=6)[0, -1])
    want = jeng.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    got = teng.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32
    # teacher-forced logits agree as well
    _close(teng.forward({"input_ids": got}),
           jeng.forward({"input_ids": got}))


def test_engine_refuses_what_is_not_ported(tiny):
    cfg, tcfg, jparams, tparams = tiny
    model = tgpt2.build(tcfg)
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"},
                                             params=tparams, device="cpu")
    with pytest.raises(ValueError, match="context length"):
        eng.generate(np.zeros((1, 120), np.int64), max_new_tokens=10)
    for cfgd in ({"tensor_parallel": {"tp_size": 2}},
                 {"sequence_parallel": 2}, {"dtype": "int8"}):
        with pytest.raises(NotImplementedError):
            deepspeed_tpu_torch.init_inference(model, config=cfgd,
                                               device="cpu")
    # ZeRO-Inference is ported; GPT-2 has no stream_hooks, and the JAX
    # engine refuses it with a ValueError too
    with pytest.raises(ValueError, match="stream_hooks"):
        deepspeed_tpu_torch.init_inference(
            model, config={"zero_inference": {"enabled": True}},
            device="cpu")
