"""ZeRO-Inference in the PyTorch port (``inference/zero_inference.py``:
the stacked blocks in host memory, streamed through the device one layer
at a time in ``generate``) against the resident engine and the JAX
package, on the CPU.

The counterparts of ``tests/unit/test_zero_inference.py``'s six cases on
its tiny OPT (the same JAX weights through ``opt.params_from_jax``):
greedy, sampling with eos, pinned layers, w8a8 records, pre-quantized
parameters and the refusals.  Each streamed ``generate`` must equal the
port's resident one token for token, and the JAX engine's streamed one
(greedy, the sampled case's seed, pinned layers, w8a8).
"""

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models import opt as topt
from deepspeed_tpu_torch.ops import quantization as tq
from deepspeed_tpu_torch.ops import quantized_matmul as tqmm

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)


def _cfgs():
    kw = dict(vocab_size=512, max_seq_len=64, num_layers=3, num_heads=2,
              hidden_size=128, ffn_size=256)
    return jopt.OPTConfig(**kw), topt.OPTConfig(**kw)


@pytest.fixture(scope="module")
def tiny():
    cfg, tcfg = _cfgs()
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        jparams = jax.device_get(jopt.build(cfg).init_fn(
            jax.random.PRNGKey(0)))
    yield cfg, tcfg, jparams
    tqmm.configure(kernel_ok=True)
    deepspeed_tpu.comm.reset_topology()


def _port(tcfg, params, dtype="float32", quant=None, **zi):
    """A port engine on the CPU; ``params``: a JAX numpy tree or the
    port's tensors."""
    config = {"dtype": dtype}
    if quant:
        config["quant"] = quant
    if zi:
        config["zero_inference"] = zi
    if not isinstance(params["embed_tokens"], torch.Tensor):
        params = topt.params_from_jax(params)
    return deepspeed_tpu_torch.init_inference(
        topt.build(tcfg), config=config, params=params, device="cpu")


def _jax(cfg, jparams, quant=None, **zi):
    deepspeed_tpu.comm.reset_topology()
    config = {"dtype": "float32"}
    if quant:
        config["quant"] = quant
    if zi:
        config["zero_inference"] = zi
    return deepspeed_tpu.init_inference(model=jopt.build(cfg),
                                        params=jparams, config=config)


def test_streamed_matches_resident_greedy(tiny):
    cfg, tcfg, jparams = tiny
    ids = np.arange(2 * 5, dtype=np.int32).reshape(2, 5) % 512
    ref = _port(tcfg, jparams).generate(ids, max_new_tokens=6)
    eng = _port(tcfg, jparams, enabled=True, prefetch=2)
    out = eng.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(ref, out)
    assert out.dtype == np.int32
    timings = eng._streamed.last_timings
    assert timings["prefill_s"] > 0 and len(timings["decode_step_s"]) == 5
    # every block byte crosses once a pass: 3 layers of 12 leaves, f32
    layer_params = (tcfg.num_params() - 512 * 128 - 66 * 128 - 2 * 128) // 3
    assert eng._streamed.streamed_bytes == 3 * 4 * layer_params
    want = _jax(cfg, jparams, enabled=True, prefetch=2).generate(
        ids, max_new_tokens=6)
    np.testing.assert_array_equal(out, want)


def test_streamed_matches_resident_sampling_and_eos(tiny):
    cfg, tcfg, jparams = tiny
    ids = np.ones((1, 4), np.int32)
    kw = dict(max_new_tokens=5, do_sample=True, temperature=0.7, top_k=7,
              top_p=0.9, seed=123, eos_token_id=3)
    ref = _port(tcfg, jparams).generate(ids, **kw)
    out = _port(tcfg, jparams, enabled=True).generate(ids, **kw)
    np.testing.assert_array_equal(ref, out)
    want = _jax(cfg, jparams, enabled=True).generate(ids, **kw)
    np.testing.assert_array_equal(out, want)
    # an eos mid-stream back-fills the rest, in both paths alike
    ids2 = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    greedy = _port(tcfg, jparams).generate(ids2, max_new_tokens=6)
    eos = int(greedy[0, 6])
    ref = _port(tcfg, jparams).generate(ids2, max_new_tokens=6,
                                        eos_token_id=eos)
    out = _port(tcfg, jparams, enabled=True).generate(
        ids2, max_new_tokens=6, eos_token_id=eos)
    np.testing.assert_array_equal(ref, out)
    assert (out[0, 6:] == eos).all()


def test_streamed_pinned_layers_parity(tiny):
    """``pin_layers`` keeps a device-resident prefix; tokens must not
    change."""
    cfg, tcfg, jparams = tiny
    ids = np.ones((1, 4), np.int32)
    ref = _port(tcfg, jparams).generate(ids, max_new_tokens=4)
    eng = _port(tcfg, jparams, enabled=True, pin_layers=2, sync_every=2)
    assert eng._streamed.pin_layers == 2
    assert len(eng._streamed._slots) == 1
    out = eng.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(ref, out)
    want = _jax(cfg, jparams, enabled=True, pin_layers=2,
                sync_every=2).generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(out, want)


def test_streamed_w8a8_parity(tiny):
    """Streaming int8 records (the 1 byte a parameter wire format) decodes
    the tokens of the resident w8a8 engine: the same records, the same
    kernels' arithmetic (B5 on a streamed layer, B6 on the resident
    stack), a different residency."""
    cfg, tcfg, jparams = tiny
    ids = np.ones((1, 4), np.int32)
    q = {"enabled": True, "type": "w8a8"}
    ref = _port(tcfg, jparams, quant=q).generate(ids, max_new_tokens=4)
    eng = _port(tcfg, jparams, quant=q, enabled=True)
    layer0 = eng._streamed.host_layers[0]
    assert tq.is_k_quantized(layer0["qkv_w"])
    assert layer0["qkv_w"]["qk"].device.type == "cpu"
    assert layer0["qkv_w"]["qk"].dtype == torch.int8
    out = eng.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(ref, out)
    # the same records as the resident engine's, layer by layer
    res = _port(tcfg, jparams, quant=q)
    for i, layer in enumerate(eng._streamed.host_layers):
        assert torch.equal(layer["fc_w"]["qk"],
                           res.params["blocks"]["fc_w"]["qk"][i])
    want = _jax(cfg, jparams, quant=q, enabled=True).generate(
        ids, max_new_tokens=4)
    np.testing.assert_array_equal(out, want)
    tqmm.configure(kernel_ok=True)


def test_streamed_engine_accepts_prequantized_params(tiny):
    """A tree already carrying K-grouped records streams as-is (no
    re-quantization, f32 scales through the bf16 cast) and decodes the
    engine-quantized resident path's tokens; a record kind that does not
    match ``quant.type`` raises."""
    _, tcfg, jparams = tiny
    ids = np.ones((1, 4), np.int32)
    q = {"enabled": True, "type": "w8a8"}
    ref = _port(tcfg, jparams, dtype="bfloat16", quant=q).generate(
        ids, max_new_tokens=4)
    cast = {k: (v.to(torch.bfloat16) if k != "blocks" else
                {n: w.to(torch.bfloat16) for n, w in v.items()})
            for k, v in topt.params_from_jax(jparams).items()}
    pre = dict(cast)
    pre["blocks"] = tq.quantize_pytree_k_grouped(cast["blocks"], k_group=128,
                                                 min_ndim=3)
    assert pre["blocks"]["qkv_w"]["kscale"].dtype == torch.float32
    eng = _port(tcfg, pre, dtype="bfloat16", quant=q, enabled=True)
    layer0 = eng._streamed.host_layers[0]
    assert layer0["qkv_w"]["kscale"].dtype == torch.float32
    assert torch.equal(layer0["qkv_w"]["qk"], pre["blocks"]["qkv_w"]["qk"][0])
    out = eng.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(ref, out)
    with pytest.raises(ValueError, match="pre-quantized"):
        _port(tcfg, pre, dtype="bfloat16",
              quant={"enabled": True, "type": "weight"}, enabled=True)
    tqmm.configure(kernel_ok=True)


@pytest.mark.parametrize("name", ["gpt2", "llama", "mixtral"])
def test_streamed_rejects_models_without_stream_hooks(name):
    model = {"gpt2": lambda: get_model("gpt2", num_layers=2, hidden_size=64,
                                       num_heads=4, max_seq_len=64,
                                       vocab_size=128),
             "llama": lambda: get_model("llama", num_layers=2,
                                        hidden_size=64, num_heads=4,
                                        num_kv_heads=2, ffn_size=128,
                                        vocab_size=128),
             "mixtral": lambda: get_model("mixtral", num_layers=2,
                                          hidden_size=64, num_heads=4,
                                          num_kv_heads=2, ffn_size=128,
                                          vocab_size=128,
                                          num_experts=4)}[name]()
    with pytest.raises(ValueError, match="stream_hooks"):
        deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "float32",
                           "zero_inference": {"enabled": True}},
            device="cpu")


def test_streamed_rejects_unsupported(tiny):
    _, tcfg, jparams = tiny
    eng = _port(tcfg, jparams, enabled=True)
    with pytest.raises(NotImplementedError, match="generate"):
        eng.forward({"input_ids": np.ones((1, 4), np.int32)})
    # over-length requests fail loudly, as on the resident path
    with pytest.raises(ValueError, match="context length"):
        eng.generate(np.ones((1, 60), np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="ONE device"):
        deepspeed_tpu_torch.init_inference(
            topt.build(tcfg), params=topt.params_from_jax(jparams),
            config={"dtype": "float32", "tensor_parallel": {"tp_size": 2},
                    "zero_inference": {"enabled": True}}, device="cpu")
    # a stack of another depth than the config's
    short = topt.params_from_jax(jparams)
    short["blocks"] = {k: v[:2] for k, v in short["blocks"].items()}
    with pytest.raises(ValueError, match="carry 2 layers"):
        _port(tcfg, short, enabled=True)
    # nothing to generate: the prompt back, timings cleared
    out = eng.generate(np.ones((2, 3), np.int32), max_new_tokens=0)
    assert out.dtype == np.int32 and out.shape == (2, 3)
    assert eng._streamed.last_timings == {"prefill_s": None,
                                          "decode_step_s": []}


def test_opt_pipeline_hooks_give_the_loss(tiny):
    """``pipeline_hooks``' embed, block and head-loss pieces compose to
    ``loss_from_batch``."""
    _, tcfg, jparams = tiny
    model = topt.build(tcfg)
    params = topt.params_from_jax(jparams)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 9))).long()
    hooks = model.pipeline_hooks
    x = hooks["embed_fn"](params, ids[:, :-1])
    for i in range(tcfg.num_layers):
        x = hooks["block_fn"]({k: v[i] for k, v in params["blocks"].items()},
                              x)
    got = hooks["head_loss_fn"](params, x, ids[:, 1:])
    want = model.loss_fn(params, {"input_ids": ids})
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert hooks["blocks_key"] == ("blocks",) and hooks["dropout"] == 0.0
