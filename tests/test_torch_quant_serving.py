"""The PyTorch port's quantized serving lanes against the JAX package's.

 - kv8 pool records: scatter (quantize on write) and gather (dequantize)
   against ``deepspeed_tpu/ops/paged_kv.py``, codes and scales bit for bit;
   the kv8 paged decode / verify attention's plain path against JAX's
   reference, GQA included.
 - GPT-2 at hidden 128 (whole 128-row k-groups) in fp32, JAX-initialised:
   ``generate`` and ``serve`` under ``kv8``, ``w8a8`` and ``w8a8+kv8``
   token-exact against the JAX package's quantized lanes (whose Pallas
   kernels run in interpret mode), logits at 1e-4; the bounded-divergence
   contract of ``tests/unit/test_quant_serving.py`` against the float lane;
   the layer-indexed decode equal to ``DS_INDEXED_DECODE=0``;
   ``quantize=None`` bit-identical to the float lane.
 - the validation errors, the device rule and the new ``stats()`` keys.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import Request as JRequest
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import decode_attention as jda
from deepspeed_tpu.ops import paged_kv as jpk
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.serving import Request, ServingEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import paged_kv as tpk
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent / "unit"))
from quant_divergence import (assert_bounded_divergence,  # noqa: E402
                              max_logit_rmse, token_match_rate)
from test_quant_serving import (KV8_MIN_MATCH,  # noqa: E402
                                W8A8_MAX_LOGIT_RMSE, W8A8_MIN_MATCH)

SERVE_KW = dict(slots=3, max_seq_len=64, block_size=8, prefill_chunk=16,
                prefill_batch=2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ pool records
def _pool_case(seed=1, b=3, hkv=2, d=16, bs=8, nbper=4, nb=13, t=8):
    rng = np.random.default_rng(seed)
    bt = rng.permutation(np.arange(1, nb))[:b * nbper] \
        .reshape(b, nbper).astype(np.int32)
    kw = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    vw = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    return bt, kw, vw, (nb, hkv, bs, d)


def test_record_pool_scatter_and_gather_match_jax():
    bt, kw, vw, shape = _pool_case()
    base = np.array([0, 8, 16], np.int32)
    valid = np.array([8, 5, 1], np.int32)
    jpool = jpk.quantize_pool(jnp.zeros(shape, jnp.float32))
    tpool = tpk.quantize_pool(torch.zeros(shape))
    assert tpk.is_quantized_pool(tpool) and tpool["qp"].dtype == torch.int8
    assert tpool["ps"].dtype == tpk.SCALE_DTYPE == torch.bfloat16
    assert tuple(tpool["ps"].shape) == shape[:-1]
    assert tpk.pool_payload(tpool) is tpool["qp"]
    tv = tpk.quantize_pool(torch.zeros(shape))
    jk, jv = jpk.paged_cache_update(jpool, jpool, jnp.asarray(kw),
                                    jnp.asarray(vw), jnp.asarray(base),
                                    jnp.asarray(bt), valid=jnp.asarray(valid))
    tpk.paged_cache_update(tpool, tv, _t(kw), _t(vw), _t(base), _t(bt),
                           valid=_t(valid))
    for got, want in ((tpool, jk), (tv, jv)):
        # scratch block 0 takes the masked tail in either order
        np.testing.assert_array_equal(got["qp"][1:].numpy(),
                                      np.asarray(want["qp"])[1:])
        np.testing.assert_array_equal(_np(got["ps"][1:]),
                                      _np(want["ps"])[1:])
        for out in (None, torch.bfloat16):
            g = tpk.paged_gather(got, _t(bt), out_dtype=out)
            w = jpk.paged_gather(want, jnp.asarray(bt), out_dtype=(
                None if out is None else jnp.bfloat16))
            assert g.dtype == (out or torch.float32)
            np.testing.assert_array_equal(_np(g), _np(w))
    # a fresh pool reads exactly 0, like the float pool's zero init
    fresh = tpk.paged_gather(tpk.quantize_pool(torch.zeros(shape)), _t(bt))
    assert fresh.abs().max().item() == 0.0


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("t", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv8_paged_attention_matches_jax(rep, t, dtype):
    """The kv8 paged decode (T == 1) and verify (T <= 16) wrappers' plain
    path against JAX's reference on the same int8 records."""
    rng = np.random.default_rng(10 * rep + t)
    b, hkv, d, bs, nbper = 3, 2, 16, 8, 5
    nb = 1 + b * nbper
    bt = rng.permutation(np.arange(1, nb)).reshape(b, nbper).astype(np.int32)
    bt[1, 4] = -1                               # clamped to scratch block 0
    x = rng.standard_normal((2, nb, hkv, bs, d)).astype(np.float32)
    q = rng.standard_normal((b, hkv * rep, t, d)).astype(np.float32)
    pos = np.array([0, 17, bs * nbper - t], np.int32)
    jpools = [dict(zip(("qp", "ps"), jq.quantize_kv(jnp.asarray(x[i]))))
              for i in range(2)]
    tpools = [dict(zip(("qp", "ps"), tq.quantize_kv(_t(x[i]))))
              for i in range(2)]
    for i in range(2):
        np.testing.assert_array_equal(tpools[i]["qp"].numpy(),
                                      np.asarray(jpools[i]["qp"]))
    qj = jnp.asarray(q, dtype)
    qt = _t(q).to(getattr(torch, dtype))
    want = jda.paged_decode_attention_reference(qj, *jpools, jnp.asarray(bt),
                                                jnp.asarray(pos))
    got = tda.paged_decode_attention(qt, *tpools, _t(bt), _t(pos))
    assert got.dtype == qt.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert [fn.launches for fn in tda.KERNELS] == [0] * 5


# ------------------------------------------------------------ the lanes
@pytest.fixture(scope="module")
def lanes():
    """JAX and port engines over the same fp32 weights: float, and w8a8."""
    cfg = jgpt2.GPT2Config(vocab_size=512, max_seq_len=64, num_layers=2,
                           num_heads=4, hidden_size=128)
    tcfg = tgpt2.GPT2Config(vocab_size=512, max_seq_len=64, num_layers=2,
                            num_heads=4, hidden_size=128)
    jp = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    tp = tgpt2.params_from_jax(jp)
    w8 = {"dtype": "fp32", "quant": {"enabled": True, "type": "w8a8"}}
    out = {"cfg": cfg, "tcfg": tcfg, "jp": jp, "tp": tp}
    for name, conf in (("float", {"dtype": "fp32"}), ("w8a8", w8)):
        deepspeed_tpu.comm.reset_topology()
        out[f"j_{name}"] = deepspeed_tpu.init_inference(
            jgpt2.build(cfg), params=jp,
            config={**conf, "tensor_parallel": {"tp_size": 1}})
        out[f"t_{name}"] = deepspeed_tpu_torch.init_inference(
            tgpt2.build(tcfg), params=tp, config=conf, device="cpu")
    return out


def _trace(n=4, seed=2, prefix_len=10, tail=(3, 8), max_new=(2, 8)):
    """``test_quant_serving.py``'s shared-prefix trace, as triples."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 512, prefix_len)
    return [(i, np.concatenate([prefix, rng.integers(0, 512,
                                                     int(rng.integers(*tail)))]),
             int(rng.integers(*max_new))) for i in range(n)]


def _generate_all(engine, trace):
    return {u: np.asarray(engine.generate(p[None, :], max_new_tokens=m)[0])
            for u, p, m in trace}


def test_w8a8_generate_and_logits_match_jax(lanes):
    prompts = np.random.default_rng(3).integers(0, 512, (3, 9))
    want = np.asarray(lanes["j_w8a8"].generate(prompts, max_new_tokens=12))
    got = lanes["t_w8a8"].generate(prompts, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)
    # teacher-forced: long rows take the dequantize path, <= 8 rows the
    # w8a8 kernel's arithmetic
    for ids in (got, got[:1, :6]):
        np.testing.assert_allclose(
            _np(lanes["t_w8a8"].forward({"input_ids": ids})),
            _np(lanes["j_w8a8"].forward({"input_ids": ids})), atol=1e-4,
            rtol=0)


@pytest.mark.parametrize("mode", ["kv8", "w8a8", "w8a8+kv8"])
def test_serve_matches_jax_quantized_lane(lanes, mode):
    trace = _trace()
    deepspeed_tpu.comm.reset_topology()
    jsrv = deepspeed_tpu.init_serving(
        jgpt2.build(lanes["cfg"]), params=lanes["jp"],
        config={"dtype": "fp32"}, quantize=mode, sampling=False, **SERVE_KW)
    tsrv = deepspeed_tpu_torch.init_serving(
        tgpt2.build(lanes["tcfg"]), params=lanes["tp"],
        config={"dtype": "fp32"}, quantize=mode, sampling=False,
        device="cpu", **SERVE_KW)
    want = jsrv.serve([JRequest(u, p, m) for u, p, m in trace])
    got = tsrv.serve([Request(u, p, m) for u, p, m in trace])
    for u, _, _ in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
    st, jst = tsrv.stats(), jsrv.stats()
    for key in ("quantize", "kv_dtype", "weight_quant", "kv_scale_bytes",
                "kv_pool_bytes", "prefix_hit_tokens", "decode_steps",
                "prefill_calls"):
        assert st[key] == jst[key], key
    if "w8a8" in mode:
        assert any(tq.is_k_quantized(v)
                   for v in tsrv.engine.params["blocks"].values())


def test_bounded_divergence_against_the_float_lane(lanes):
    """``test_quant_serving.py``'s contract on the port: kv8 and w8a8+kv8
    served traces against the float lane's ``generate`` at KV8_MIN_MATCH /
    W8A8_MIN_MATCH, and the w8a8 engine's teacher-forced logit RMSE within
    W8A8_MAX_LOGIT_RMSE."""
    trace = _trace()
    want = _generate_all(lanes["t_float"], trace)
    kv8 = ServingEngine(lanes["t_float"], quantize="kv8", **SERVE_KW)
    assert_bounded_divergence(
        want, kv8.serve([Request(u, p, m) for u, p, m in trace]),
        KV8_MIN_MATCH, "port kv8")
    both = ServingEngine(lanes["t_w8a8"], quantize="w8a8+kv8", **SERVE_KW)
    assert_bounded_divergence(
        want, both.serve([Request(u, p, m) for u, p, m in trace]),
        W8A8_MIN_MATCH, "port w8a8+kv8")
    rmse = max_logit_rmse(lanes["t_float"], lanes["t_w8a8"],
                          [p for _, p, _ in trace[:2]])
    assert 0 < rmse <= W8A8_MAX_LOGIT_RMSE, rmse


def test_indexed_decode_equals_per_layer_decode(lanes, monkeypatch):
    """The layer-indexed loop (stacked w8a8 path, device layer index) and
    ``DS_INDEXED_DECODE=0`` (per-layer records) give the same tokens and
    the same logits, bit for bit."""
    eng = lanes["t_w8a8"]
    prompts = np.random.default_rng(5).integers(0, 512, (4, 7))
    monkeypatch.setenv("DS_INDEXED_DECODE", "1")
    assert tgpt2.use_indexed_decode(eng.params["blocks"], rows=4)
    indexed = eng.generate(prompts, max_new_tokens=10)
    cache = eng.module.decode_hooks["init_cache"](4, 32, torch.float32)
    ids = torch.from_numpy(indexed[:, :1].astype(np.int64))
    li, _ = eng.module.decode_hooks["forward_cached"](eng.params, ids,
                                                      cache, 0)
    monkeypatch.setenv("DS_INDEXED_DECODE", "0")
    assert not tgpt2.use_indexed_decode(eng.params["blocks"], rows=4)
    per_layer = eng.generate(prompts, max_new_tokens=10)
    cache = eng.module.decode_hooks["init_cache"](4, 32, torch.float32)
    lp, _ = eng.module.decode_hooks["forward_cached"](eng.params, ids,
                                                      cache, 0)
    np.testing.assert_array_equal(indexed, per_layer)
    assert torch.equal(li, lp)


def test_quantize_none_is_bit_identical(lanes):
    """``quantize=None`` (and the default) serves the float lane exactly:
    tokens equal to ``generate``, a float pool and no scale table."""
    trace = _trace(seed=7)
    want = _generate_all(lanes["t_float"], trace)
    for kw in ({"quantize": None}, {}):
        srv = ServingEngine(lanes["t_float"], **SERVE_KW, **kw)
        got = srv.serve([Request(u, p, m) for u, p, m in trace])
        assert token_match_rate(want, got) == 1.0
        for u in want:
            np.testing.assert_array_equal(got[u], want[u])
        st = srv.stats()
        assert st["quantize"] is None and st["kv_dtype"] == "float32"
        assert st["kv_scale_bytes"] == 0 and st["weight_quant"] is None
        assert isinstance(srv._cache["k"], torch.Tensor)


def test_stats_account_codes_plus_scales(lanes):
    kv8 = ServingEngine(lanes["t_float"], quantize="kv8", **SERVE_KW)
    plain = ServingEngine(lanes["t_float"], **SERVE_KW)
    st, pst = kv8.stats(), plain.stats()
    assert st["quantize"] == "kv8" and st["kv_dtype"] == "int8"
    assert st["weight_quant"] is None
    payload = 2 * kv8._cache["k"]["qp"].numel()
    assert st["kv_scale_bytes"] == 2 * kv8._cache["k"]["ps"].numel() * 2
    assert st["kv_pool_bytes"] == payload + st["kv_scale_bytes"]
    # the fp32 pool as bf16 against codes + scales: 2 hd / (hd + 2)
    assert pst["kv_pool_bytes"] // 2 / st["kv_pool_bytes"] >= 1.8 - 0.11
    for key in ("paged_decode_attention_kv8_cuda_launches",
                "paged_verify_attention_kv8_cuda_launches",
                "w8a8_matmul_cuda_launches",
                "w8a8_matmul_stacked_cuda_launches",
                "quantized_matmul_cuda_launches"):
        assert st[key] == 0, key


def test_validation_errors(lanes):
    model = tgpt2.build(lanes["tcfg"])
    with pytest.raises(ValueError, match="expected one of"):
        ServingEngine(lanes["t_float"], quantize="int4", **SERVE_KW)
    with pytest.raises(ValueError, match="expected one of"):
        ServingEngine(lanes["t_float"], quantize="kv8+kv8", **SERVE_KW)
    with pytest.raises(ValueError, match="full-precision weights"):
        ServingEngine(lanes["t_float"], quantize="w8a8", **SERVE_KW)
    assert ServingEngine(lanes["t_w8a8"], quantize="kv8+w8a8",
                         **SERVE_KW).quantize == "w8a8+kv8"
    for config in ({"dtype": "fp32", "quant": {"enabled": False}},
                   DeepSpeedInferenceConfig(dtype="fp32",
                                            quant={"enabled": False})):
        with pytest.raises(ValueError, match="enabled=False"):
            deepspeed_tpu_torch.init_serving(model, config=config,
                                             quantize="w8a8", sampling=False,
                                             device="cpu", **SERVE_KW)
    # an un-pinned config object gains the w8a8 block, the caller's stays
    conf = DeepSpeedInferenceConfig(dtype="fp32")
    srv = deepspeed_tpu_torch.init_serving(model, config=conf,
                                           quantize="w8a8", sampling=False,
                                           device="cpu", **SERVE_KW)
    assert srv.weight_quant == "w8a8" and not conf.quant.enabled
    no_kv = tgpt2.build(lanes["tcfg"])
    no_kv.decode_hooks = dict(no_kv.decode_hooks, supports_kv_quant=False)
    eng = deepspeed_tpu_torch.init_inference(no_kv, config={"dtype": "fp32"},
                                             device="cpu")
    with pytest.raises(ValueError, match="supports_kv_quant"):
        ServingEngine(eng, quantize="kv8", **SERVE_KW)
    with pytest.raises(ValueError, match="'weight' or 'w8a8'"):
        deepspeed_tpu_torch.init_inference(
            model, device="cpu",
            config={"quant": {"enabled": True, "type": "int4"}})


def test_quantized_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    model = tgpt2.build(tgpt2.GPT2Config.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_serving(model, quantize="w8a8+kv8",
                                         sampling=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(
            model, config={"quant": {"enabled": True, "type": "w8a8"}})
