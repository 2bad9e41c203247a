"""Per-architecture injection policies — the PyTorch port of
``deepspeed_tpu/module_inject/replace_policy.py``.

An :class:`HFPolicy` maps a HuggingFace architecture to a config
translation (HF config -> the port's model config), a weight conversion
(HF state dict -> the stacked parameter tree, float32 CPU tensors) and a
model constructor.  ``replace_module(hf_model)`` is the reference's
``replace_transformer_layer`` (``replace_module.py:308``): given a HF
model, or its config and state dict, it returns ``(model, params)`` ready
for ``init_inference``.

The HF config may be a ``transformers`` config object, or any object or
dict with HF's attribute names (``architectures``, ``model_type``,
``n_layer``, ...): a ``config.json`` read with ``json`` is enough (it
carries every model-specific key), so nothing here imports
``transformers``.

Policies exist for gpt2, opt, llama, mixtral, bloom, gpt_neox, gptj,
gpt_neo, bert, distilbert (a BERT with a one-row zero token-type table)
and clip.  A ``config.json``'s nested configs (CLIP's ``text_config`` /
``vision_config``) are read as :class:`HFConfig` too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..models.common import hf_getter, hf_tensor

Params = Dict[str, Any]


@dataclasses.dataclass
class HFPolicy:
    arch: str                                  # HF `architectures[0]` name
    translate_config: Callable[[Any], Any]     # hf config -> our config
    convert_weights: Callable[[Any, Dict], Params]  # (cfg, state_dict)
    build: Callable[[Any], Any]                # cfg -> model


_t = hf_tensor


#: ``model_type`` -> the architecture whose policy serves it, for configs
#: without ``architectures``
MODEL_TYPES = {"gpt2": "GPT2LMHeadModel", "opt": "OPTForCausalLM",
               "llama": "LlamaForCausalLM", "mixtral": "MixtralForCausalLM",
               "bloom": "BloomForCausalLM",
               "gpt_neox": "GPTNeoXForCausalLM", "gptj": "GPTJForCausalLM",
               "gpt_neo": "GPTNeoForCausalLM", "bert": "BertForMaskedLM",
               "distilbert": "DistilBertForMaskedLM", "clip": "CLIPModel"}


class HFConfig:
    """Attribute access over a ``config.json`` dict with HF's names (a
    nested ``*_config`` dict, CLIP's towers, wrapped alike);
    GPT-Neo's ``attention_layers``, when absent, is expanded from
    ``attention_types`` as ``transformers.GPTNeoConfig`` expands it."""

    def __init__(self, d: Dict[str, Any]):
        d = {k: HFConfig(v) if k.endswith("_config") and isinstance(v, dict)
             else v for k, v in d.items()}
        if d.get("model_type") == "gpt_neo" and "attention_layers" not in d:
            d["attention_layers"] = [kind for kinds, n in
                                     d["attention_types"]
                                     for _ in range(n) for kind in kinds]
        self.__dict__.update(d)

    def __getattr__(self, name):
        raise AttributeError(f"HF config has no {name!r}")


def as_hf_config(config):
    """A dict becomes :class:`HFConfig`; anything else passes through."""
    return HFConfig(config) if isinstance(config, dict) else config


# ----------------------------------------------------------------- GPT-2
def _gpt2_translate(hf):
    from ..models.gpt2 import GPT2Config
    return GPT2Config(vocab_size=hf.vocab_size, max_seq_len=hf.n_positions,
                      num_layers=hf.n_layer, num_heads=hf.n_head,
                      hidden_size=hf.n_embd)


def _gpt2_convert(cfg, sd) -> Params:
    get = hf_getter(sd, ("transformer.", ""), "GPT-2")

    def stack(fmt):
        return _t(np.stack([get(fmt.format(i=i))
                            for i in range(cfg.num_layers)]))

    # HF GPT-2 uses Conv1D: weights already [in, out] — no transpose
    return {
        "wte": _t(get("wte.weight")),
        "wpe": _t(get("wpe.weight")),
        "blocks": {
            "ln1_scale": stack("h.{i}.ln_1.weight"),
            "ln1_bias": stack("h.{i}.ln_1.bias"),
            "qkv_w": stack("h.{i}.attn.c_attn.weight"),
            "qkv_b": stack("h.{i}.attn.c_attn.bias"),
            "o_w": stack("h.{i}.attn.c_proj.weight"),
            "o_b": stack("h.{i}.attn.c_proj.bias"),
            "ln2_scale": stack("h.{i}.ln_2.weight"),
            "ln2_bias": stack("h.{i}.ln_2.bias"),
            "fc_w": stack("h.{i}.mlp.c_fc.weight"),
            "fc_b": stack("h.{i}.mlp.c_fc.bias"),
            "proj_w": stack("h.{i}.mlp.c_proj.weight"),
            "proj_b": stack("h.{i}.mlp.c_proj.bias"),
        },
        "lnf_scale": _t(get("ln_f.weight")),
        "lnf_bias": _t(get("ln_f.bias")),
    }


def _gpt2_build(cfg):
    from ..models import gpt2
    return gpt2.build(cfg)


# ------------------------------------------------------------------- OPT
def _opt_translate(hf):
    from ..models.opt import OPTConfig
    return OPTConfig.from_hf(hf)


def _opt_convert(cfg, sd) -> Params:
    from ..models.opt import from_hf_state_dict
    return from_hf_state_dict(cfg, sd)


def _opt_build(cfg):
    from ..models import opt
    return opt.build(cfg)


# ----------------------------------------------------------------- Llama
def _llama_translate(hf):
    from ..models.llama import LlamaConfig
    return LlamaConfig(
        vocab_size=hf.vocab_size, max_seq_len=hf.max_position_embeddings,
        num_layers=hf.num_hidden_layers, num_heads=hf.num_attention_heads,
        num_kv_heads=hf.num_key_value_heads, hidden_size=hf.hidden_size,
        ffn_size=hf.intermediate_size,
        rope_theta=getattr(hf, "rope_theta", 10000.0))


def _llama_convert(cfg, sd, include_mlp: bool = True) -> Params:
    """The Llama-family trunk (embeddings, attention, norms, head);
    ``include_mlp=False`` for Mixtral, whose FFN keys live under
    ``block_sparse_moe``."""
    get = hf_getter(sd, ("model.", ""), "Llama")

    def stack(fmt, transpose=True):
        rows = [get(fmt.format(i=i)) for i in range(cfg.num_layers)]
        return _t(np.stack([r.T if transpose else r for r in rows]))

    if "lm_head.weight" in sd:
        lm_head = _t(get("lm_head.weight").T)
    else:  # tied
        lm_head = _t(get("embed_tokens.weight").T)
    blocks = {
        "attn_norm": stack("layers.{i}.input_layernorm.weight",
                           transpose=False),
        "q_w": stack("layers.{i}.self_attn.q_proj.weight"),
        "k_w": stack("layers.{i}.self_attn.k_proj.weight"),
        "v_w": stack("layers.{i}.self_attn.v_proj.weight"),
        "o_w": stack("layers.{i}.self_attn.o_proj.weight"),
        "mlp_norm": stack("layers.{i}.post_attention_layernorm.weight",
                          transpose=False),
    }
    if include_mlp:
        blocks["w1"] = stack("layers.{i}.mlp.gate_proj.weight")
        blocks["w3"] = stack("layers.{i}.mlp.up_proj.weight")
        blocks["w2"] = stack("layers.{i}.mlp.down_proj.weight")
    return {
        "embed": _t(get("embed_tokens.weight")),
        "blocks": blocks,
        "final_norm": _t(get("norm.weight")),
        "lm_head": lm_head,
    }


def _llama_build(cfg):
    from ..models import llama
    return llama.build(cfg)


# ----------------------------------------------------------------- Mixtral
def _mixtral_translate(hf):
    from ..models.mixtral import MixtralConfig
    return MixtralConfig(
        vocab_size=hf.vocab_size, max_seq_len=hf.max_position_embeddings,
        num_layers=hf.num_hidden_layers, num_heads=hf.num_attention_heads,
        num_kv_heads=hf.num_key_value_heads, hidden_size=hf.hidden_size,
        ffn_size=hf.intermediate_size,
        rope_theta=getattr(hf, "rope_theta", 1e6),
        num_experts=hf.num_local_experts, top_k=hf.num_experts_per_tok,
        # drop-free routing, HF's semantics
        eval_capacity_factor=float(hf.num_local_experts))


def _mixtral_convert(cfg, sd) -> Params:
    base = _llama_convert(cfg, sd, include_mlp=False)
    blocks = base["blocks"]
    get = hf_getter(sd, ("model.", ""), "Llama")
    l, e = cfg.num_layers, cfg.num_experts

    def stack_experts(w_name):
        # HF expert Linear stores [out, in]; ours is [l, e, in, out]
        return _t(np.stack([
            np.stack([get(f"layers.{i}.block_sparse_moe.experts.{j}."
                          f"{w_name}.weight").T for j in range(e)])
            for i in range(l)]))

    blocks["gate_w"] = _t(np.stack(
        [get(f"layers.{i}.block_sparse_moe.gate.weight").T
         for i in range(l)]))
    blocks["experts_w1"] = stack_experts("w1")
    blocks["experts_w2"] = stack_experts("w2")
    blocks["experts_w3"] = stack_experts("w3")
    return base


def _mixtral_build(cfg):
    from ..models import mixtral
    return mixtral.build(cfg)


# ------------------------------------------- the families of this module
def _family(name: str, config: str):
    """(translate, convert, build) of ``models.<name>``: its
    ``<config>.from_hf``, ``from_hf_state_dict`` and ``build``."""
    def module():
        import importlib
        return importlib.import_module(f"..models.{name}", __package__)

    return (lambda hf: getattr(module(), config).from_hf(hf),
            lambda cfg, sd: module().from_hf_state_dict(cfg, sd),
            lambda cfg: module().build(cfg))


# ----------------------------------------------------------- DistilBERT
def _distilbert_translate(hf):
    """DistilBERT is a post-LN BERT without token-type embeddings or
    pooler (``replace_policy.py:300``): the BERT encoder with a one-row
    zero token-type table."""
    from ..models.bert import BertConfig
    act = getattr(hf, "activation", "gelu")
    if act not in ("gelu", "gelu_new"):
        raise NotImplementedError(f"distilbert: activation={act!r}")
    return BertConfig(vocab_size=hf.vocab_size,
                      max_seq_len=hf.max_position_embeddings,
                      type_vocab_size=1, num_layers=hf.n_layers,
                      num_heads=hf.n_heads, hidden_size=hf.dim,
                      intermediate_size=hf.hidden_dim, layer_norm_eps=1e-12)


def _distilbert_convert(cfg, sd) -> Params:
    get = hf_getter(sd, ("distilbert.", ""), "DistilBERT")
    l = cfg.num_layers  # noqa: E741
    layer = "transformer.layer.{i}."

    def stack(fmt, transpose=False):
        rows = [get(fmt.format(i=i)) for i in range(l)]
        return _t(np.stack([r.T if transpose else r for r in rows]))

    def qkv(kind, transpose):
        rows = []
        for i in range(l):
            parts = [get(f"transformer.layer.{i}.attention.{p}_lin.{kind}")
                     for p in ("q", "k", "v")]
            rows.append(np.concatenate([w.T for w in parts], axis=1)
                        if transpose else np.concatenate(parts))
        return _t(np.stack(rows))

    # the head decodes through the (tied) word embeddings: a projector that
    # is not tied is refused (a tied one may be absent from the dict)
    try:
        proj = get("vocab_projector.weight")
    except KeyError:
        proj = None
    if proj is not None and not np.allclose(
            proj, get("embeddings.word_embeddings.weight")):
        raise NotImplementedError(
            "distilbert: untied vocab_projector is unsupported "
            "(tie_word_embeddings=False)")
    return {
        "word_embeddings": _t(get("embeddings.word_embeddings.weight")),
        "position_embeddings": _t(
            get("embeddings.position_embeddings.weight")),
        "token_type_embeddings": _t(np.zeros((1, cfg.hidden_size),
                                             np.float32)),
        "emb_ln_scale": _t(get("embeddings.LayerNorm.weight")),
        "emb_ln_bias": _t(get("embeddings.LayerNorm.bias")),
        "blocks": {
            "qkv_w": qkv("weight", True),
            "qkv_b": qkv("bias", False),
            "attn_out_w": stack(layer + "attention.out_lin.weight", True),
            "attn_out_b": stack(layer + "attention.out_lin.bias"),
            "attn_ln_scale": stack(layer + "sa_layer_norm.weight"),
            "attn_ln_bias": stack(layer + "sa_layer_norm.bias"),
            "inter_w": stack(layer + "ffn.lin1.weight", True),
            "inter_b": stack(layer + "ffn.lin1.bias"),
            "out_w": stack(layer + "ffn.lin2.weight", True),
            "out_b": stack(layer + "ffn.lin2.bias"),
            "out_ln_scale": stack(layer + "output_layer_norm.weight"),
            "out_ln_bias": stack(layer + "output_layer_norm.bias"),
        },
        "mlm_dense_w": _t(get("vocab_transform.weight").T),
        "mlm_dense_b": _t(get("vocab_transform.bias")),
        "mlm_ln_scale": _t(get("vocab_layer_norm.weight")),
        "mlm_ln_bias": _t(get("vocab_layer_norm.bias")),
        "mlm_bias": _t(get("vocab_projector.bias")),
    }


_POLICIES: Dict[str, HFPolicy] = {}


def _register(arch, translate, convert, build):
    _POLICIES[arch.lower()] = HFPolicy(arch, translate, convert, build)


_register("BertForMaskedLM", *_family("bert", "BertConfig"))
_register("DistilBertForMaskedLM", _distilbert_translate, _distilbert_convert,
          _family("bert", "BertConfig")[2])
_register("GPT2LMHeadModel", _gpt2_translate, _gpt2_convert, _gpt2_build)
_register("OPTForCausalLM", _opt_translate, _opt_convert, _opt_build)
_register("LlamaForCausalLM", _llama_translate, _llama_convert, _llama_build)
_register("MixtralForCausalLM", _mixtral_translate, _mixtral_convert,
          _mixtral_build)
_register("BloomForCausalLM", *_family("bloom", "BloomConfig"))
_register("GPTNeoXForCausalLM", *_family("gptneox", "GPTNeoXConfig"))
_register("GPTJForCausalLM", *_family("gptj", "GPTJConfig"))
_register("GPTNeoForCausalLM", *_family("gptneo", "GPTNeoConfig"))
_register("CLIPModel", *_family("clip", "CLIPConfig"))


def generic_policies():
    return list(_POLICIES.values())


def policy_for(model_or_config) -> Optional[HFPolicy]:
    """The policy of a HF model or config (object or dict) by its
    ``architectures``, its class name, or its ``model_type``."""
    cfg = getattr(model_or_config, "config", model_or_config)
    cfg = as_hf_config(cfg)
    archs = getattr(cfg, "architectures", None) or []
    names = list(archs) + [type(model_or_config).__name__]
    mtype = getattr(cfg, "model_type", None)
    if mtype in MODEL_TYPES:
        names.append(MODEL_TYPES[mtype])
    for name in names:
        pol = _POLICIES.get(str(name).lower())
        if pol is not None:
            return pol
    return None


def replace_module(hf_model=None, config=None, state_dict=None):
    """HF model -> ``(model, params)`` (reference ``replace_module.py:308``).

    Pass either a torch HF model, or its ``config`` (object or dict) and
    ``state_dict`` (tensors or numpy arrays)."""
    if hf_model is not None:
        if getattr(hf_model, "config", None) is None:
            raise ValueError(
                f"replace_module: {type(hf_model).__name__} is not a "
                "HuggingFace model (it has no .config)")
        config = hf_model.config
        state_dict = hf_model.state_dict()
    if config is None or state_dict is None:
        raise ValueError("replace_module needs hf_model, or config and "
                         "state_dict")
    pol = policy_for(hf_model if hf_model is not None else config)
    if pol is None:
        archs = getattr(as_hf_config(config), "architectures", None)
        raise ValueError(
            f"no injection policy for architecture {archs}; supported: "
            f"{sorted(p.arch for p in _POLICIES.values())}")
    cfg = pol.translate_config(as_hf_config(config))
    params = pol.convert_weights(cfg, dict(state_dict))
    return pol.build(cfg), params
