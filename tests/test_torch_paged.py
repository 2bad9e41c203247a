"""The PyTorch port's paged-KV host structures and device ops against the
JAX package: chain keys and checksums byte-identical, allocator and prefix
trie behaviour, the paged scatter/gather in fp32, and the copied config."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JConfig
from deepspeed_tpu.ops import paged_kv as jkv
from deepspeed_tpu_torch.inference import paged as tpaged
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.ops import paged_kv as tkv

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)


@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_chain_keys_and_checksums_byte_equal(block_size):
    rng = np.random.default_rng(block_size)
    toks = rng.integers(0, 50257, 7 * block_size + 3)
    n = len(toks) // block_size
    want = jpaged.chain_keys(toks, n, block_size)
    got = tpaged.chain_keys(toks, n, block_size)
    assert got == want and all(len(k) == tpaged.CHAIN_KEY_BYTES for k in got)
    assert [tpaged.chain_key(toks, i, block_size) for i in range(n)] == want
    # prefix dependence: changing token 0 changes every key
    toks2 = toks.copy()
    toks2[0] += 1
    assert all(a != b for a, b in
               zip(tpaged.chain_keys(toks2, n, block_size), want))
    arrays = [rng.standard_normal((2, block_size, 8)).astype(np.float32),
              rng.integers(-127, 127, (2, block_size), dtype=np.int8)]
    assert tpaged.block_checksum(arrays) == jpaged.block_checksum(arrays)


def _drive(mod):
    """One allocator + trie script, run on either package; returns the
    observable trace."""
    a = mod.BlockAllocator(8)
    pc = mod.PrefixCache(block_size=2)
    trace = [a.free_blocks]
    toks = np.arange(6)
    blocks = [a.alloc() for _ in range(3)]
    pc.register(toks, blocks, a)
    trace += [len(pc), [a.refcount(b) for b in blocks]]
    trace += [pc.probe(toks, 6), pc.probe(toks, 5)]
    got = pc.lookup(np.concatenate([toks[:4], [9, 9]]), 6, a)
    trace += [got, [a.refcount(b) for b in blocks]]
    for b in got + blocks:
        a.decref(b)
    trace += [pc.evictable(a), pc.evict_one(a), pc.probe(toks, 6)]
    trace += [pc.evict_one(a), pc.evict_one(a), pc.evict_one(a)]
    trace += [len(pc), a.free_blocks, a.blocks_in_use]
    more = [a.alloc() for _ in range(8)]
    trace += [more, a.alloc()]
    return trace


def test_allocator_and_prefix_trie_match_jax():
    assert _drive(tpaged) == _drive(jpaged)


def test_allocator_refcounts_and_errors():
    a = tpaged.BlockAllocator(5)                # 1 scratch + 4 usable
    blocks = [a.alloc() for _ in range(4)]
    assert sorted(blocks) == [1, 2, 3, 4] and a.alloc() is None
    assert tpaged.SCRATCH_BLOCK not in blocks
    a.incref(blocks[0])
    a.decref(blocks[0])
    assert a.free_blocks == 0
    a.decref(blocks[0])
    assert a.free_blocks == 1 and a.alloc() == blocks[0]
    with pytest.raises(AssertionError):
        a.incref(tpaged.SCRATCH_BLOCK)
    with pytest.raises(ValueError):
        tpaged.BlockAllocator(1)


def test_prefix_cache_first_writer_wins_and_held_blocks_stay():
    a = tpaged.BlockAllocator(10)
    pc = tpaged.PrefixCache(block_size=2)
    toks = np.arange(4)
    b1 = [a.alloc(), a.alloc()]
    b2 = [a.alloc(), a.alloc()]
    pc.register(toks, b1, a)
    pc.register(toks, b2, a)
    assert len(pc) == 2 and pc.lookup(toks, 4, a) == b1
    assert a.refcount(b2[0]) == 1
    assert pc.evictable(a) == 0 and pc.evict_one(a) is None


def test_paged_update_and_gather_match_jax():
    """Per-row bases, valid masking, pads and out-of-table positions routed
    to scratch block 0, negative table entries; fp32 bit-exact (pure data
    movement)."""
    rng = np.random.default_rng(0)
    b, hkv, d, bs, nbper, nb, t = 3, 2, 8, 4, 4, 14, 6
    bt = rng.permutation(np.arange(1, nb))[:b * nbper].reshape(b, nbper)
    bt = bt.astype(np.int32)
    bt[2, 3] = -1
    kp = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    vp = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    kw = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    vw = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    base = np.array([0, 5, 13], np.int32)       # row 2 runs past the table
    valid = np.array([6, 3, 2], np.int32)
    for v_ in (valid, None):
        jk, jv = jkv.paged_cache_update(
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kw),
            jnp.asarray(vw), jnp.asarray(base), jnp.asarray(bt),
            valid=None if v_ is None else jnp.asarray(v_))
        tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        tkv.paged_cache_update(tk, tv, torch.from_numpy(kw),
                               torch.from_numpy(vw), torch.from_numpy(base),
                               torch.from_numpy(bt),
                               valid=None if v_ is None
                               else torch.from_numpy(v_))
        # scratch block 0 takes the discarded writes in an unspecified order
        np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
        np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
        np.testing.assert_array_equal(
            tkv.paged_gather(tk, torch.from_numpy(bt)).numpy()[:, :, :12],
            np.asarray(jkv.paged_gather(jk, jnp.asarray(bt)))[:, :, :12])
    # scalar position: every row writes at the same base
    tk = torch.from_numpy(kp.copy())
    tkv.paged_cache_update(tk, torch.from_numpy(vp.copy()),
                           torch.from_numpy(kw[:, :, :1]),
                           torch.from_numpy(vw[:, :, :1]), 7,
                           torch.from_numpy(bt))
    jk, _ = jkv.paged_cache_update(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(kw[:, :, :1]),
                                   jnp.asarray(vw[:, :, :1]), 7,
                                   jnp.asarray(bt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tkv.blocks_for(33, 16) == jkv.blocks_for(33, 16) == 3


def test_inference_config_keys_and_aliases():
    d = {"replace_with_kernel_inject": True, "dtype": "fp16",
         "tp": {"tp_size": 1}, "max_out_tokens": 77, "min_tokens": 3,
         "max_out_batch": 5, "sp": 1, "quant": {"group_size": 64}}
    t, j = DeepSpeedInferenceConfig(**d), JConfig(**d)
    for key in ("kernel_inject", "dtype", "max_tokens", "min_out_tokens",
                "max_batch_size", "sequence_parallel", "enable_cuda_graph"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.tensor_parallel.tp_size == j.tensor_parallel.tp_size == 1
    assert t.quant.group_size == 64 and not t.quant.enabled
    assert t.torch_dtype == torch.float16
    assert DeepSpeedInferenceConfig(dtype="bf16").torch_dtype == torch.bfloat16
    assert DeepSpeedInferenceConfig().torch_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        DeepSpeedInferenceConfig(strict=True, no_such_key=1)
    assert DeepSpeedInferenceConfig(no_such_key=1).no_such_key == 1

