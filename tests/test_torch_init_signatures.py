"""The port's entry points against the JAX package's signatures: every
keyword of ``deepspeed_tpu.init_serving`` / ``init_inference`` /
``initialize`` is named by ``deepspeed_tpu_torch``'s, with the JAX default;
a keyword the port does not implement yet accepts its JAX default only, and
any other value raises ``NotImplementedError`` naming its ROADMAP Queue A
item (no keyword falls through ``**kwargs`` into the inference config).
The keywords the port implements still build servers that decode what
``generate`` decodes (``GPT2Config.tiny()``, fp32, ``device="cpu"``)."""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.serving import Request
from deepspeed_tpu_torch.models import gpt2 as tgpt2

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

#: init_serving's keywords the port implements
PORTED = {"model", "config", "params", "slots", "max_seq_len",
          "prefill_batch", "block_size", "num_blocks", "prefill_chunk",
          "prefix_caching", "decode_steps", "sampling", "quantize",
          "spec_tokens", "draft", "ngram_max", "ngram_min", "spec_verifier",
          "logit_masks", "prompt_buckets", "chunked_prefill",
          "debug_checks", "trace_capacity", "slo_targets", "peak_flops",
          "kwargs"}

# (keyword, a value other than the JAX default, its ROADMAP Queue A item)
UNPORTED = [
    ("engine_mode", "dp_tp", 8),
    ("sp", 2, 8),
    ("resident_window_blocks", 4, 9),
    ("host_blocks", 8, 9),
    ("swap_batch", 4, 9),
    ("role", "prefill", 9),
    ("nvme_blocks", 4, 9),
    ("nvme_high_watermark", 0.5, 9),
    ("nvme_path", "kv.spill", 9),
    ("shard_kv", True, 8),
    ("topology", 2, 8),
]


def _params(fn):
    return inspect.signature(fn).parameters


@pytest.mark.parametrize("name", ["init_serving", "init_inference",
                                  "initialize"])
def test_entry_points_name_every_jax_keyword_with_its_default(name):
    want, got = (_params(getattr(deepspeed_tpu, name)),
                 _params(getattr(deepspeed_tpu_torch, name)))
    for p in want.values():
        assert p.name in got, f"{name} lacks {p.name}"
        assert got[p.name].kind == p.kind, p.name
        assert got[p.name].default == p.default, p.name
    assert set(got) - set(want) == {"device"}


#: the block-sparse attention entry points, each with its JAX counterpart's
#: signature (``interpret``: accepted and ignored)
SPARSE = ["sparse_attention", "SparseSelfAttention",
          "SparseSelfAttention.__call__", "SparsityConfig",
          "DenseSparsityConfig", "FixedSparsityConfig",
          "VariableSparsityConfig", "BigBirdSparsityConfig",
          "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig"]


def _attr(module, path):
    for name in path.split("."):
        module = getattr(module, name)
    return module


@pytest.mark.parametrize("name", SPARSE)
def test_sparse_attention_entry_points_keep_the_jax_signatures(name):
    from deepspeed_tpu.ops import sparse_attention as jsa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    want, got = _params(_attr(jsa, name)), _params(_attr(tsa, name))
    assert list(got) == list(want), name
    for p in want.values():
        assert got[p.name].kind == p.kind, p.name
        assert got[p.name].default == p.default, p.name
    assert tsa.__all__ == jsa.__all__


def _method_pairs():
    """(label, JAX callable, port callable) for the serving methods, the
    request record, ``generate`` and the llama, mixtral and opt families'
    builders."""
    from deepspeed_tpu.inference import engine as jeng
    from deepspeed_tpu.inference import serving as jsrv
    from deepspeed_tpu.models import llama as jllama
    from deepspeed_tpu.models import mixtral as jmix
    from deepspeed_tpu.models import opt as jopt
    from deepspeed_tpu.models import bloom as jbloom
    from deepspeed_tpu.models import gptj as jgptj
    from deepspeed_tpu.models import gptneo as jgptneo
    from deepspeed_tpu.models import gptneox as jgptneox
    from deepspeed_tpu.module_inject import replace_policy as jpol
    from deepspeed_tpu.runtime import engine as jtrain
    from deepspeed_tpu.runtime import state_dict_factory as jsdf
    from deepspeed_tpu_torch.inference import engine as teng
    from deepspeed_tpu_torch.models import bloom as tbloom
    from deepspeed_tpu_torch.models import gptj as tgptj
    from deepspeed_tpu_torch.models import gptneo as tgptneo
    from deepspeed_tpu_torch.models import gptneox as tgptneox
    from deepspeed_tpu_torch.module_inject import replace_policy as tpol
    from deepspeed_tpu_torch.runtime import state_dict_factory as tsdf
    from deepspeed_tpu_torch.inference import serving as tsrv
    from deepspeed_tpu_torch.models import llama as tllama
    from deepspeed_tpu_torch.models import mixtral as tmix
    from deepspeed_tpu_torch.models import opt as topt
    from deepspeed_tpu_torch.runtime import engine as ttrain

    return [
        ("ServingEngine.submit", jsrv.ServingEngine.submit,
         tsrv.ServingEngine.submit),
        ("ServingEngine.serve", jsrv.ServingEngine.serve,
         tsrv.ServingEngine.serve),
        ("Request", jsrv.Request, tsrv.Request),
        ("InferenceEngine.generate", jeng.InferenceEngine.generate,
         teng.InferenceEngine.generate),
        ("llama.build", jllama.build, tllama.build),
        ("LlamaConfig", jllama.LlamaConfig, tllama.LlamaConfig),
        ("mixtral.build", jmix.build, tmix.build),
        ("MixtralConfig", jmix.MixtralConfig, tmix.MixtralConfig),
        ("opt.build", jopt.build, topt.build),
        ("OPTConfig", jopt.OPTConfig, topt.OPTConfig),
        ("replace_module", jpol.replace_module, tpol.replace_module),
        ("policy_for", jpol.policy_for, tpol.policy_for),
        ("load_hf_weights", jsdf.load_hf_weights, tsdf.load_hf_weights),
        ("bloom.build", jbloom.build, tbloom.build),
        ("BloomConfig", jbloom.BloomConfig, tbloom.BloomConfig),
        ("gptneox.build", jgptneox.build, tgptneox.build),
        ("GPTNeoXConfig", jgptneox.GPTNeoXConfig, tgptneox.GPTNeoXConfig),
        ("gptj.build", jgptj.build, tgptj.build),
        ("GPTJConfig", jgptj.GPTJConfig, tgptj.GPTJConfig),
        ("gptneo.build", jgptneo.build, tgptneo.build),
        ("GPTNeoConfig", jgptneo.GPTNeoConfig, tgptneo.GPTNeoConfig),
        ("DeepSpeedEngine.save_checkpoint",
         jtrain.DeepSpeedEngine.save_checkpoint,
         ttrain.DeepSpeedEngine.save_checkpoint),
        ("DeepSpeedEngine.load_checkpoint",
         jtrain.DeepSpeedEngine.load_checkpoint,
         ttrain.DeepSpeedEngine.load_checkpoint),
    ]


METHODS = ["ServingEngine.submit", "ServingEngine.serve", "Request",
           "InferenceEngine.generate", "llama.build", "LlamaConfig",
           "mixtral.build", "MixtralConfig", "opt.build", "OPTConfig",
           "replace_module", "policy_for", "load_hf_weights", "bloom.build",
           "BloomConfig", "gptneox.build", "GPTNeoXConfig", "gptj.build",
           "GPTJConfig", "gptneo.build", "GPTNeoConfig",
           "DeepSpeedEngine.save_checkpoint",
           "DeepSpeedEngine.load_checkpoint"]


@pytest.mark.parametrize("name", METHODS)
def test_methods_keep_the_jax_signatures(name):
    """Every parameter of the JAX method, in its order, with its kind and
    default (a keyword the port does not implement is taken at that
    default only: see the test below)."""
    _, jfn, tfn = next(p for p in _method_pairs() if p[0] == name)
    want, got = _params(jfn), _params(tfn)
    assert list(got) == list(want), name
    for p in want.values():
        assert got[p.name].kind == p.kind, p.name
        assert got[p.name].default == p.default, p.name


# (method, keyword, a value other than the JAX default): the serving
# methods' keywords, each ported; every one takes a value other than its
# default and the call still serves what ``generate`` decodes
METHOD_KEYWORDS = [
    ("submit", "slo_class", "realtime"),
    ("serve", "step_log", []),
    ("serve", "debug_checks", True),
    ("serve", "profile_dir", "prof"),
    ("serve", "profile_iters", 4),
]


@pytest.mark.parametrize("method,keyword,value", METHOD_KEYWORDS,
                         ids=[k for _, k, _ in METHOD_KEYWORDS])
def test_unported_method_keywords_refuse_other_values(engine, method, keyword,
                                                      value, tmp_path):
    """The serving methods' keywords take values other than the JAX
    default (the name is kept from when they were refused): the call
    serves ``generate``'s tokens, and each keyword does its job — the
    class's priority, the step log, the audits, the profiler trace."""
    srv = deepspeed_tpu_torch.init_serving(
        engine.module, params=engine.params, config={"dtype": "fp32"},
        device="cpu", slots=2, max_seq_len=64, block_size=8, sampling=False)
    req = Request(uid=0, prompt=np.arange(5), max_new_tokens=2)
    want = engine.generate(np.arange(5)[None], max_new_tokens=2)[0]
    if keyword == "profile_dir":
        value = str(tmp_path / value)
    if method == "submit":
        handle = srv.submit(req, **{keyword: value})
        while srv.step():
            pass
        out = handle.result(timeout=0)
        assert handle.priority == 2 and handle.slo_class == "realtime"
        assert srv.slo_report()["realtime"]["requests"] == 1
    else:
        kw = {keyword: value}
        if keyword == "profile_iters":
            kw["profile_dir"] = str(tmp_path / "p")
        out = srv.serve([req], **kw)[0]
        st = srv.stats()
        if keyword == "step_log":
            assert len(value) == st["iterations"] > 0
        if keyword == "debug_checks":
            assert st["invariant_checks_run"] == st["iterations"]
        if "profile_dir" in kw:
            import os

            assert os.listdir(kw["profile_dir"])
    np.testing.assert_array_equal(out, want)


def test_every_unported_serving_keyword_is_listed():
    assert {k for k, _, _ in UNPORTED} == \
        set(_params(deepspeed_tpu.init_serving)) - PORTED


@pytest.fixture(scope="module")
def model():
    return tgpt2.build(tgpt2.GPT2Config.tiny())


@pytest.mark.parametrize("keyword,value,item", UNPORTED,
                         ids=[k for k, _, _ in UNPORTED])
def test_unported_serving_keywords_refuse_other_values(model, keyword, value,
                                                       item):
    kw = {"sampling": False, keyword: value}
    with pytest.raises(NotImplementedError,
                       match=rf"{keyword}=.*Queue A item {item}\)"):
        deepspeed_tpu_torch.init_serving(model, device="cpu", **kw)


@pytest.mark.parametrize("name,layers", [("llama-3-8b", 32),
                                         ("Llama_3.70B", 80), ("gpt2", 12),
                                         ("mixtral-8x7b", 32),
                                         ("opt-13b", 40), ("bloom-7b1", 30),
                                         ("gptj-6b", 28),
                                         ("gpt-neox-20b", 44),
                                         ("gpt-neo-2.7b", 32),
                                         ("pythia-160m", 12)])
def test_get_model_keeps_the_jax_names(name, layers):
    from deepspeed_tpu_torch import models

    assert models.get_model(name).model_config.num_layers == layers
    assert models.get_model(name, num_layers=2).model_config.num_layers == 2


@pytest.mark.parametrize("name", ["bert-base", "clip-vit-b32", "sd-vae"])
def test_get_model_refuses_families_it_does_not_port(name):
    """The encoder and diffusion families, the last the JAX zoo had and
    the port refused, now build by the JAX names, each with the JAX
    package's named config (every family of Queue A item 7 is ported)."""
    from deepspeed_tpu.models import get_model as jget_model
    from deepspeed_tpu_torch import models

    got = models.get_model(name)
    assert dataclasses.asdict(got.model_config) == \
        dataclasses.asdict(jget_model(name).model_config)
    assert got.name == jget_model(name).name
    assert models.get_model(name, **_smaller(name)).model_config != \
        got.model_config


def _smaller(name):
    """One field override of each named config."""
    return {"bert-base": {"num_layers": 2}, "clip-vit-b32":
            {"text_layers": 2}, "sd-vae": {"base_channels": 32}}[name]


def test_init_inference_refuses_models_it_does_not_port(tmp_path):
    """A model that is neither the port's nor a HuggingFace one and a path
    without ``config.json`` are refused; an HF BERT directory
    (``"model_type": "bert"``, a ``.safetensors`` the port writes in HF
    names, as ``chip_smoke.py`` phase 23 writes BERT-base), refused while
    its family was not ported, now loads and runs ``forward``."""
    import chip_smoke
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.runtime.state_dict_factory import \
        write_safetensors

    with pytest.raises(ValueError, match="not a HuggingFace model"):
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(4, 4),
                                           device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        deepspeed_tpu_torch.init_inference(str(tmp_path / "gpt2"),
                                           device="cpu")
    cfg = bert.BertConfig.tiny(vocab_size=64, max_seq_len=16)
    params = bert.init_params(cfg, torch.Generator().manual_seed(0))
    conf = chip_smoke.hf_config("bert", cfg)
    del conf["architectures"]       # model_type alone names the policy
    (tmp_path / "config.json").write_text(json.dumps(conf))
    write_safetensors(chip_smoke.bert_hf_state_dict(params),
                      str(tmp_path / "model.safetensors"))
    engine = deepspeed_tpu_torch.init_inference(
        str(tmp_path), config={"dtype": "fp32"}, device="cpu")
    assert engine.module.model_config == cfg
    ids = np.arange(24).reshape(2, 12) % 64
    want = bert.forward(cfg, params, torch.as_tensor(ids))
    np.testing.assert_allclose(engine.forward({"input_ids": ids}).numpy(),
                               want.detach().numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def engine(model):
    return deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "fp32"}, device="cpu")


# the keywords the port implements, and every unported one at its JAX
# default given explicitly (chunked_prefill also at True, which the port
# runs): init_serving(model) as the JAX package is called, sampling=True
# included
_JAX_DEFAULTS = {k: _params(deepspeed_tpu.init_serving)[k].default
                 for k, _, _ in UNPORTED}
SERVERS = [
    ("defaults", {}),
    ("prefill_chunk=16", {"prefill_chunk": 16}),
    ("prefix_caching=False", {"prefix_caching": False}),
    ("chunked_prefill=True", {"chunked_prefill": True}),
    ("every JAX default spelled out", _JAX_DEFAULTS),
    ("kv8", {"quantize": "kv8"}),
    ("sampling=True", {"sampling": True}),
    ("sampling=False", {"sampling": False}),
    ("decode_steps=4", {"decode_steps": 4}),
    ("sampling=True decode_steps=4", {"sampling": True, "decode_steps": 4}),
    ("spec_tokens=3", {"spec_tokens": 3}),
    ("spec_tokens=4 ngram_max=2 ngram_min=2",
     {"spec_tokens": 4, "ngram_max": 2, "ngram_min": 2}),
    ("spec_verifier=greedy sampling=False",
     {"spec_tokens": 3, "spec_verifier": "greedy", "sampling": False}),
    ("spec_tokens=3 kv8", {"spec_tokens": 3, "quantize": "kv8"}),
    ("draft model", {"spec_tokens": 3, "draft": "draft"}),
    ("draft model sampling=False",
     {"spec_tokens": 2, "draft": "draft", "sampling": False}),
    ("logit_masks", {"logit_masks": True}),
    ("logit_masks spec_tokens=3", {"logit_masks": True, "spec_tokens": 3}),
    # the keywords that were refused until the serving API slice
    ("prompt_buckets", {"prompt_buckets": [16, 32, 64]}),
    ("chunked_prefill=False", {"chunked_prefill": False}),
    ("debug_checks", {"debug_checks": True}),
    ("trace_capacity=0", {"trace_capacity": 0}),
    ("slo_targets", {"slo_targets": {"realtime": {"ttft_s": 1.0}}}),
    ("peak_flops", {"peak_flops": 1e12}),
]


@pytest.fixture(scope="module")
def greedy_trace(engine):
    """The servers' trace (4 prompts over a shared 16-token prefix) and
    ``generate``'s 6 greedy tokens for each, computed once for every case
    of :func:`test_ported_serving_keywords_build_working_servers`."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, 16)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, n)])
               for n in (3, 9, 5, 12)]
    return prompts, [np.asarray(engine.generate(
        p[None].astype(np.int64), max_new_tokens=6))[0] for p in prompts]


@pytest.mark.parametrize("label,kw", SERVERS, ids=[s[0] for s in SERVERS])
def test_ported_serving_keywords_build_working_servers(engine, greedy_trace,
                                                       label, kw):
    """Each server serves a greedy trace (temperature-0 rows on a sampling
    server are the argmax) token-exact with ``generate``; speculative
    servers run rounds, a ``draft`` model (a 1-layer GPT-2) is wrapped
    with the target's config."""
    if kw.get("draft") == "draft":
        kw = dict(kw, draft=tgpt2.build(tgpt2.GPT2Config(
            vocab_size=512, max_seq_len=64, num_layers=1, num_heads=2,
            hidden_size=32)))
    srv = deepspeed_tpu_torch.init_serving(
        engine.module, params=engine.params, config={"dtype": "fp32"},
        device="cpu", slots=3, max_seq_len=64, block_size=8, **kw)
    prompts, greedy = greedy_trace
    out = srv.serve([Request(uid=i, prompt=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):        # prompt + 6 new tokens
        np.testing.assert_array_equal(np.asarray(out[i])[:len(p)], p)
        assert len(out[i]) == len(p) + 6
        if "quantize" in kw:
            assert srv.stats()["kv_dtype"] == "int8"
            continue
        np.testing.assert_array_equal(np.asarray(out[i]), greedy[i])
    st = srv.stats()
    assert st["sampling"] is kw.get("sampling", True)
    assert (st["fused_iterations"] > 0) == (kw.get("decode_steps", 1) > 1)
    assert (st["spec_rounds"] > 0) == bool(kw.get("spec_tokens"))
    assert st["logit_masks"] is kw.get("logit_masks", False)
    assert st["mode"] == ("bucketed" if "prompt_buckets" in kw or
                          kw.get("chunked_prefill") is False else "chunked")
    assert st["invariant_checks_run"] == (
        st["iterations"] if kw.get("debug_checks") else 0)
    assert st["trace_capacity"] == kw.get("trace_capacity", 16384)
    assert srv.resolved_config()["peak_flops"] == kw.get("peak_flops")
    if "slo_targets" in kw:
        assert srv.slo_report()["realtime"]["ttft_target_s"] == 1.0


# -------------------------------------------------------------- GPT2Config
#: (field, a non-default value not ported yet, its ROADMAP Queue A item)
GPT2_UNPORTED = [
    ("act_quant_bits", 8, 10), ("act_quant_type", "asymmetric", 10),
    ("random_ltd_keep", 16, 10), ("random_ltd_layer_start", 0, 10),
    ("random_ltd_layer_num", 1, 10), ("sparse_embedding_grad", True, 8),
    ("scan_group_size", 2, 8), ("sp_impl", "ring", 8),
]


def test_gpt2_config_has_every_jax_field_in_order():
    """The port's ``GPT2Config`` names every field of the JAX one, in its
    order and with its default, so a JAX config carries over (positional
    construction included)."""
    import dataclasses

    from deepspeed_tpu.models import gpt2 as jgpt2

    want = [(f.name, f.default) for f in dataclasses.fields(jgpt2.GPT2Config)]
    got = [(f.name, f.default) for f in dataclasses.fields(tgpt2.GPT2Config)]
    assert got == want
    jcfg = jgpt2.GPT2Config(remat=True, remat_policy="dots_flash",
                            remat_offload=True, fused_ce=True, ce_chunks=3,
                            dropout=0.1, scan_layers=False)
    tcfg = tgpt2.GPT2Config(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("field,value,item", GPT2_UNPORTED,
                         ids=[u[0] for u in GPT2_UNPORTED])
def test_gpt2_config_refuses_unported_values(field, value, item):
    with pytest.raises(NotImplementedError,
                       match=rf"Queue A {item}\)"):
        tgpt2.GPT2Config(**{field: value})


def test_gpt2_config_checks_its_remat_policy():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tgpt2.GPT2Config(remat=True, remat_policy="everything")
    for policy in ("full", "dots", "dots_flash"):
        assert tgpt2.GPT2Config(remat=True,
                                remat_policy=policy).remat_policy == policy
