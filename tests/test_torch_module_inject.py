"""The PyTorch port's HuggingFace ingestion against the JAX package's, on
the CPU: ``module_inject.replace_module`` and its policies,
``runtime.state_dict_factory`` (HF directories, the port's safetensors
reader and writer, Megatron merges) and ``checkpoint.ds_native``
(torch-DeepSpeed directories).

 - for each ported architecture a tiny random HF model built from its
   ``transformers`` config (no download): the port's params equal the JAX
   ``replace_module``'s, and its fp32 logits equal the HF model's within
   1e-4;
 - ``init_inference`` of a checkpoint directory (``.bin``, sharded index
   JSON, ``.safetensors``) and of an in-memory model decodes what the same
   weights given as ``params`` decode; in a process where ``transformers``
   and ``safetensors`` cannot be imported too;
 - the port's safetensors reader equals ``safetensors.numpy.load_file``,
   bfloat16 included;
 - Megatron checkpoints of qkv versions 0, 1.0 and 2.0 at tp 1 and 2 equal
   to the JAX merge;
 - torch-DeepSpeed ZeRO-2, ZeRO-3, tp 2 and pp 2 x tp 2 directories equal
   to the JAX loader's;
 - the bert, distilbert and clip policies convert a tiny HF state dict
   given with its ``config.json`` dict into the JAX policy's tree.
"""

import json
import math
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import transformers

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import ds_native as jds
from deepspeed_tpu.models import megatron_gpt as jmeg
from deepspeed_tpu.runtime import state_dict_factory as jsdf
from deepspeed_tpu_torch.checkpoint import ds_native as tds
from deepspeed_tpu_torch.models import megatron_gpt as tmeg
from deepspeed_tpu_torch.module_inject import replace_policy as tpol
from deepspeed_tpu_torch.runtime import state_dict_factory as tsdf

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
_NO_DROP = dict(attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0)
#: architecture -> (transformers config class, model class, kwargs)
HF = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel",
             dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2,
                  n_head=4, **_NO_DROP)),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=96, hidden_size=32, ffn_dim=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=64, word_embed_proj_dim=32,
                 dropout=0.0, pad_token_id=1)),
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=64,
                   rms_norm_eps=1e-5)),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, num_local_experts=4,
                     num_experts_per_tok=2, max_position_embeddings=64,
                     rope_theta=10000.0, rms_norm_eps=1e-5,
                     attention_dropout=0.0)),
    "bloom": ("BloomConfig", "BloomForCausalLM",
              dict(vocab_size=96, hidden_size=32, n_layer=2, n_head=4,
                   hidden_dropout=0.0, attention_dropout=0.0)),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM",
                 dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=64, rotary_pct=0.5,
                      hidden_act="gelu", attention_dropout=0.0,
                      hidden_dropout=0.0)),
    "gptj": ("GPTJConfig", "GPTJForCausalLM",
             dict(vocab_size=96, n_embd=32, n_layer=2, n_head=4,
                  n_positions=64, rotary_dim=4, **_NO_DROP)),
    "gpt_neo": ("GPTNeoConfig", "GPTNeoForCausalLM",
                dict(vocab_size=96, hidden_size=32, num_layers=2,
                     num_heads=4, max_position_embeddings=64, window_size=4,
                     attention_types=[[["global", "local"], 1]],
                     attention_dropout=0.0, embed_dropout=0.0,
                     resid_dropout=0.0)),
}
ARCHS = list(HF)


def _hf_model(arch, seed=0):
    cfg_cls, model_cls, kw = HF[arch]
    torch.manual_seed(seed)
    with torch.no_grad():
        model = getattr(transformers, model_cls)(
            getattr(transformers, cfg_cls)(**kw))
        # random biases and norms (HF zero-inits biases, unit-inits norms)
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.add_(0.05 * torch.randn_like(p))
    return model.eval()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_replace_module_matches_jax_and_hf(arch):
    hf = _hf_model(arch)
    model, params = deepspeed_tpu_torch.replace_module(hf_model=hf)
    _, jparams = deepspeed_tpu.module_inject.replace_module(hf_model=hf)
    _assert_trees_equal({k: v for k, v in _leaves(params)},
                        {k: v for k, v in _leaves(jax.device_get(jparams))})
    ids = np.random.default_rng(0).integers(2, 96, (2, 12))
    with torch.no_grad():
        want = hf(torch.as_tensor(ids)).logits.numpy()
        got = model(params, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the same through a config dict (a config.json read with json)
    cfg = json.loads(hf.config.to_json_string())
    _, again = tpol.replace_module(config=cfg, state_dict=hf.state_dict())
    _assert_trees_equal(dict(_leaves(again)), dict(_leaves(params)))


#: the encoder architectures: (transformers config class, model class,
#: kwargs)
ENCODERS = {
    "bert": ("BertConfig", "BertForMaskedLM",
             dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=32)),
    "distilbert": ("DistilBertConfig", "DistilBertForMaskedLM",
                   dict(vocab_size=96, dim=32, n_layers=2, n_heads=4,
                        hidden_dim=64, max_position_embeddings=32)),
    "clip": ("CLIPConfig", "CLIPModel",
             dict(text_config=dict(vocab_size=96, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4,
                                   max_position_embeddings=16),
                  vision_config=dict(hidden_size=48, intermediate_size=96,
                                     num_hidden_layers=2,
                                     num_attention_heads=4, image_size=32,
                                     patch_size=16),
                  projection_dim=24)),
}


@pytest.mark.parametrize("arch", ["bert", "distilbert", "clip"])
def test_later_policies_raise_naming_item_7(arch):
    """The bert, distilbert and clip policies, which raised while their
    families were not ported, convert a tiny HF state dict given with its
    ``config.json`` dict (``model_type`` alone names the policy) into the
    JAX policy's tree, leaf for leaf; the port registers as many policies
    as the JAX package."""
    cfg_cls, model_cls, kw = ENCODERS[arch]
    torch.manual_seed(1)
    hf = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(
        **kw)).eval()
    cfg = json.loads(hf.config.to_json_string())
    cfg.pop("architectures", None)
    pol = tpol.policy_for(cfg)
    assert pol is not None and pol in tpol.generic_policies()
    model, params = tpol.replace_module(config=cfg,
                                        state_dict=hf.state_dict())
    _, jparams = deepspeed_tpu.module_inject.replace_module(hf_model=hf)
    _assert_trees_equal(dict(_leaves(params)),
                        dict(_leaves(jax.device_get(jparams))))
    assert model.decode_hooks is None and model.apply_fn is not None
    assert len(tpol.generic_policies()) == len(
        deepspeed_tpu.module_inject.generic_policies())


def test_unknown_models_and_paths_are_refused(tmp_path):
    with pytest.raises(ValueError, match="no injection policy"):
        tpol.replace_module(config={"architectures": ["T5Model"]},
                            state_dict={})
    with pytest.raises(ValueError, match="not a HuggingFace model"):
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(4, 4),
                                           device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        deepspeed_tpu_torch.init_inference(str(tmp_path), device="cpu")


# ------------------------------------------------ checkpoint directories
def _save(hf, path: Path, fmt: str):
    """``hf`` as a checkpoint directory: ``bin`` (``pytorch_model.bin``),
    ``sharded`` (``.bin`` shards and their index JSON) or ``safetensors``
    (``model.safetensors`` by the port's writer)."""
    if fmt == "safetensors":
        path.mkdir(parents=True)
        hf.config.to_json_file(str(path / "config.json"))
        tsdf.write_safetensors(
            {k: v.contiguous() for k, v in hf.state_dict().items()},
            str(path / "model.safetensors"))
    else:
        hf.save_pretrained(str(path), safe_serialization=False,
                           max_shard_size="40KB" if fmt == "sharded"
                           else "10GB")
    return path


def _generate(model, params=None):
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "fp32"}, params=params, device="cpu")
    prompts = np.random.default_rng(3).integers(2, 96, (2, 7))
    return eng.generate(prompts, max_new_tokens=5)


@pytest.mark.parametrize("arch,fmt", [("bloom", "bin"),
                                      ("gpt_neox", "sharded"),
                                      ("gptj", "safetensors"),
                                      ("gpt_neo", "bin")])
def test_init_inference_of_a_checkpoint_directory(arch, fmt, tmp_path):
    hf = _hf_model(arch, seed=1)
    path = _save(hf, tmp_path / arch, fmt)
    if fmt == "sharded":
        assert (path / "pytorch_model.bin.index.json").exists()
        assert len(tsdf.get_sd_loader_json(str(path))) > 1
    model, params = tpol.replace_module(hf_model=hf)
    want = _generate(model, params)
    np.testing.assert_array_equal(_generate(str(path)), want)
    np.testing.assert_array_equal(_generate(hf), want)


def test_safetensors_reader_equals_the_safetensors_package(tmp_path):
    import ml_dtypes  # noqa: F401  (numpy learns bfloat16)
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    rng = np.random.default_rng(4)
    tensors = {"w": torch.randn(5, 7).to(torch.bfloat16),
               "h": torch.randn(3).half(), "f": torch.randn(2, 3, 4),
               "i": torch.as_tensor(rng.integers(-9, 9, (6,)), dtype=torch.int64),
               "q": torch.arange(-4, 5, dtype=torch.int8),
               "e": torch.zeros(0, 3)}
    theirs = tmp_path / "theirs.safetensors"
    ours = tmp_path / "ours.safetensors"
    save_file(tensors, str(theirs))
    tsdf.write_safetensors(tensors, str(ours))
    for path in (theirs, ours):
        want = load_file(str(path))
        got = tsdf.read_safetensors(str(path))
        assert list(got) == list(want)
        for k, v in want.items():
            g = got[k]
            assert tuple(g.shape) == v.shape, k
            if g.dtype == torch.bfloat16:
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              v.view(np.int16), err_msg=k)
            else:
                np.testing.assert_array_equal(g.numpy(), v, err_msg=k)


FAKE_HF = r'''
import builtins, json, sys
real_import = builtins.__import__
def guarded(name, *a, **k):
    if name.split(".")[0] in ("transformers", "safetensors", "jax",
                              "deepspeed_tpu"):
        raise ImportError(f"{name} is blocked")
    return real_import(name, *a, **k)
builtins.__import__ = guarded
import numpy as np, torch
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.runtime.state_dict_factory import read_safetensors

class Config:
    def __init__(self, d):
        self.__dict__.update(d)

class HFLike(torch.nn.Module):
    """A model with HF's .config and state dict, not from transformers."""
    def __init__(self, path):
        super().__init__()
        self.config = Config(json.load(open(path + "/config.json")))
        self.sd = read_safetensors(path + "/model.safetensors")
    def state_dict(self):
        return dict(self.sd)

path = sys.argv[1]
prompts = np.random.default_rng(3).integers(2, 96, (2, 7))
out = []
for model in (path, HFLike(path)):
    eng = dt.init_inference(model, config={"dtype": "fp32"}, device="cpu")
    out.append(eng.generate(prompts, max_new_tokens=5).tolist())
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("transformers", "safetensors"))
assert not bad, bad
print(json.dumps(out))
'''


def test_ingestion_without_transformers_or_safetensors(tmp_path):
    """A checkpoint directory and an in-memory model with HF's config and
    state dict (not a ``transformers`` class) load in a process where
    ``transformers``, ``safetensors`` and JAX cannot be imported."""
    hf = _hf_model("bloom", seed=2)
    path = _save(hf, tmp_path / "bloom", "safetensors")
    model, params = tpol.replace_module(hf_model=hf)
    want = _generate(model, params).tolist()
    out = subprocess.run([sys.executable, "-c", FAKE_HF, str(path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [want, want]


# --------------------------------------------------------------- Megatron
def _megatron_full(rng, version, h=4, d=32, layers=2, vocab=96, s=32):
    """A tp-1 Megatron GPT state dict, qkv rows in ``version``'s layout."""
    hn = d // h

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def layout(a):
        """Rows q|k|v contiguous (h heads of hn each) -> ``version``'s."""
        rest = a.shape[1:]
        x = a.reshape((3, h, hn) + rest)
        if version == 1.0:
            x = x.permute((1, 2, 0) + tuple(range(3, x.ndim)))
        elif version == 2.0:
            x = x.permute((1, 0, 2) + tuple(range(3, x.ndim)))
        return x.reshape((3 * d,) + rest).contiguous()

    sd = {"word_embeddings.weight": t(vocab, d),
          "position_embeddings.weight": t(s, d),
          "final_layernorm.weight": t(d), "final_layernorm.bias": t(d)}
    for i in range(layers):
        p = f"layers.{i}."
        sd[p + "input_layernorm.weight"] = t(d)
        sd[p + "input_layernorm.bias"] = t(d)
        sd[p + "attention.query_key_value.weight"] = layout(t(3 * d, d))
        sd[p + "attention.query_key_value.bias"] = layout(t(3 * d))
        sd[p + "attention.dense.weight"] = t(d, d)
        sd[p + "attention.dense.bias"] = t(d)
        sd[p + "post_attention_layernorm.weight"] = t(d)
        sd[p + "post_attention_layernorm.bias"] = t(d)
        sd[p + "mlp.dense_h_to_4h.weight"] = t(4 * d, d)
        sd[p + "mlp.dense_h_to_4h.bias"] = t(4 * d)
        sd[p + "mlp.dense_4h_to_h.weight"] = t(d, 4 * d)
        sd[p + "mlp.dense_4h_to_h.bias"] = t(d)
    return sd


def _megatron_shards(sd, version, tp):
    """``sd`` split over ``tp`` ranks as Megatron shards it."""
    if tp == 1:
        return [sd]
    shards = [{} for _ in range(tp)]
    for name, v in sd.items():
        if "query_key_value" in name:
            if version == 0:     # each rank: its heads of q, of k, of v
                parts = [torch.chunk(z, tp, 0) for z in torch.chunk(v, 3, 0)]
                pieces = [torch.cat([p[r] for p in parts]) for r in range(tp)]
            else:                # rows interleaved by head: whole heads
                pieces = torch.chunk(v, tp, 0)
        elif "word_embeddings" in name or "h_to_4h" in name:
            pieces = torch.chunk(v, tp, 0)
        elif name.endswith(("dense.weight", "4h_to_h.weight")):
            pieces = torch.chunk(v, tp, 1)
        else:
            pieces = [v] * tp
        for r in range(tp):
            shards[r][name] = pieces[r].clone()
    return shards


@pytest.mark.parametrize("version", [0, 1.0, 2.0])
@pytest.mark.parametrize("tp", [1, 2])
def test_megatron_merge_matches_jax(version, tp, tmp_path):
    sd = _megatron_full(np.random.default_rng(5), version)
    shards = _megatron_shards(sd, version, tp)
    files = []
    for r, shard in enumerate(shards):
        files.append(str(tmp_path / f"mp_rank_{r:02d}.pt"))
        torch.save({"model": {"language_model": {"transformer": shard}},
                    "checkpoint_version": version}, files[-1])
    # Megatron stores no head count (the loaders would guess 64-wide heads)
    model, got = tsdf.get_sd_loader(files, version=version)(
        tmeg.config_from_state_dicts(shards, num_heads=4))
    spec, want = jsdf.get_sd_loader(files, version=version)(
        jmeg.config_from_state_dicts(shards, num_heads=4))
    _assert_trees_equal(dict(_leaves(got)),
                        dict(_leaves(jax.device_get(want))))
    for key in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                "hidden_size"):
        assert getattr(model.model_config, key) == \
            getattr(spec.model_config, key), key
    # the tp merge gives the unsharded checkpoint's tree
    whole = tmeg.from_megatron_state_dicts(
        tmeg.config_from_state_dict(sd, num_heads=4), [sd],
        ckpt_version=version)
    _assert_trees_equal(dict(_leaves(got)), dict(_leaves(whole)))
    # and the merged (version 0 and 1.0 / 2.0 alike) q|k|v layout is JAX's
    # de-interleave of the unsharded rows
    rows = sd["layers.1.attention.query_key_value.weight"].numpy()
    np.testing.assert_array_equal(
        got["blocks"]["qkv_w"][1].numpy(),
        jmeg._deinterleave_qkv(rows, 4, version).T)


# ------------------------------------------------------- torch-DeepSpeed
def _hf_gpt2_sd(rng, v=96, s=32, layers=2, d=16):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd = OrderedDict([("wte.weight", t(v, d)), ("wpe.weight", t(s, d))])
    for i in range(layers):
        p = f"h.{i}."
        for name, shape in (("ln_1.weight", (d,)), ("ln_1.bias", (d,)),
                            ("attn.c_attn.weight", (d, 3 * d)),
                            ("attn.c_attn.bias", (3 * d,)),
                            ("attn.c_proj.weight", (d, d)),
                            ("attn.c_proj.bias", (d,)),
                            ("ln_2.weight", (d,)), ("ln_2.bias", (d,)),
                            ("mlp.c_fc.weight", (d, 4 * d)),
                            ("mlp.c_fc.bias", (4 * d,)),
                            ("mlp.c_proj.weight", (4 * d, d)),
                            ("mlp.c_proj.bias", (d,))):
            sd[p + name] = t(*shape)
    sd["ln_f.weight"], sd["ln_f.bias"] = t(d), t(d)
    return sd


def _module_file(path, module, **extra):
    torch.save({"module": module,
                "param_shapes": [OrderedDict((k, v.shape)
                                             for k, v in module.items())],
                "buffer_names": [], "ds_version": "0.8.2", **extra}, path)


def _write_zero(dirpath, sd, stage, dp=2):
    """The reference's ZeRO layouts: a half-precision module file and one
    flat fp32 partition a data-parallel rank — stage 2 one flat buffer
    split with 2 x dp alignment padding, stage 3 each parameter split
    (padded) and the rank's pieces concatenated."""
    dirpath.mkdir(parents=True)
    _module_file(dirpath / "mp_rank_00_model_states.pt",
                 OrderedDict((k, v.half()) for k, v in sd.items()),
                 global_steps=7)
    if stage == 2:
        flat = torch.cat([v.reshape(-1) for v in sd.values()])
        padded = math.ceil(flat.numel() / (2 * dp)) * 2 * dp
        flat = torch.cat([flat, torch.zeros(padded - flat.numel())])
        parts = list(torch.chunk(flat, dp))
        key = "single_partition_of_fp32_groups"
    else:
        per = [[] for _ in range(dp)]
        for v in sd.values():
            flat = v.reshape(-1)
            part = math.ceil(flat.numel() / dp)
            flat = torch.cat([flat, torch.zeros(part * dp - flat.numel())])
            for r in range(dp):
                per[r].append(flat[r * part:(r + 1) * part])
        parts = [torch.cat(p) for p in per]
        key = "fp32_flat_groups"
    for r in range(dp):
        torch.save({"optimizer_state_dict": {
            "zero_stage": stage, key: [parts[r].clone()]}},
            dirpath / f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt")


def _tp2(name, v, r):
    """Rank ``r``'s tp-2 shard of a GPT-2 parameter (the merge rules run
    backwards)."""
    if any(p.fullmatch(name) for p in jds.GPT2_QKV_FUSED):
        return torch.cat([torch.chunk(z, 2, -1)[r]
                          for z in torch.chunk(v, 3, -1)], -1)
    if any(p.fullmatch(name) for p in jds.GPT2_REPLICATED):
        return v
    for pat, dim in jds.GPT2_CAT_DIMS:
        if pat.fullmatch(name):
            return torch.chunk(v, 2, dim % v.ndim)[r].clone()
    return v


def _write_tp2(dirpath, sd):
    dirpath.mkdir(parents=True)
    for r in range(2):
        _module_file(dirpath / f"mp_rank_{r:02d}_model_states.pt",
                     OrderedDict((k, _tp2(k, v, r)) for k, v in sd.items()))


def _write_pp2_tp2(dirpath, sd, layers=2):
    """Pipeline-staged files ``layer_{idx}-model_{tp}-model_states.pt``
    with local names: embeddings, one file a block, the final norm."""
    dirpath.mkdir(parents=True)
    files = {0: ["wte.weight", "wpe.weight"], layers + 1:
             ["ln_f.weight", "ln_f.bias"]}
    for i in range(layers):
        files[1 + i] = [k for k in sd if k.startswith(f"h.{i}.")]
    for idx, names in files.items():
        for r in range(2):
            local = OrderedDict(
                (n.split(".", 2)[2] if n.startswith("h.") else n,
                 _tp2(n, sd[n], r)) for n in names)
            torch.save(local, dirpath /
                       f"layer_{idx:02d}-model_{r:02d}-model_states.pt")


@pytest.mark.parametrize("layout", ["zero2", "zero3", "tp2", "pp2_tp2"])
def test_ds_native_matches_jax(layout, tmp_path):
    sd = _hf_gpt2_sd(np.random.default_rng(6))
    path = tmp_path / "ck"
    if layout == "zero2":
        _write_zero(path / "global_step7", sd, 2)
        (path / "latest").write_text("global_step7")
    elif layout == "zero3":
        _write_zero(path, sd, 3)
    elif layout == "tp2":
        _write_tp2(path, sd)
    else:
        _write_pp2_tp2(path, sd)
        got = tds.DeepSpeedNativeCheckpoint(str(path))
        want = jds.DeepSpeedNativeCheckpoint(str(path))
        assert got.tp_degree == want.tp_degree == 2
        merged = got.merged_fp32_state_dict()
        assert set(merged) == set(sd)
        for k, v in want.merged_fp32_state_dict().items():
            np.testing.assert_array_equal(merged[k], v, err_msg=k)
            np.testing.assert_allclose(merged[k], sd[k].numpy(), atol=1e-6)
        return
    params, cfg, client = tds.load_ds_checkpoint_into(str(path))
    jparams, jcfg, jclient = jds.load_ds_checkpoint_into(str(path))
    assert client == jclient
    assert cfg.num_layers == jcfg.num_layers == 2
    _assert_trees_equal(dict(_leaves(params)),
                        dict(_leaves(jax.device_get(jparams))))
    # the fp32 master wins over the half-precision module (ZeRO), and the
    # tp merge restores the unsharded weights
    np.testing.assert_array_equal(params["blocks"]["qkv_w"][1].numpy(),
                                  sd["h.1.attn.c_attn.weight"].numpy())
