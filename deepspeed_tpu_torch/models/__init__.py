"""Model zoo of the PyTorch port: the families ported so far, by the JAX
package's names (``deepspeed_tpu/models/__init__.py``)."""

import dataclasses

from . import (bert, bloom, clip, gpt2, gptj, gptneo, gptneox, llama,
               megatron_gpt, mixtral, opt, unet, vae)


def _with(cfg, overrides):
    """Apply kwargs onto a named config dataclass instead of dropping them."""
    return dataclasses.replace(cfg, **overrides)


_NAMED = {
    "gpt2": lambda kw: gpt2.build(**kw),
    "gpt2125m": lambda kw: gpt2.build(_with(gpt2.GPT2Config.gpt2_125m(), kw)),
    "llama": lambda kw: llama.build(**kw),
    "llama38b": lambda kw: llama.build(_with(llama.LlamaConfig.llama3_8b(),
                                             kw)),
    "llama370b": lambda kw: llama.build(_with(llama.LlamaConfig.llama3_70b(),
                                              kw)),
    "mixtral": lambda kw: mixtral.build(**kw),
    "mixtral8x7b": lambda kw: mixtral.build(
        _with(mixtral.MixtralConfig.mixtral_8x7b(), kw)),
    "bert": lambda kw: bert.build(**kw),
    "bertbase": lambda kw: bert.build(_with(bert.BertConfig.bert_base(), kw)),
    "bertlarge": lambda kw: bert.build(_with(bert.BertConfig.bert_large(),
                                             kw)),
    "vae": lambda kw: vae.build(**kw),
    "sdvae": lambda kw: vae.build(_with(vae.VAEConfig.sd_vae(), kw)),
    "unet": lambda kw: unet.build(**kw),
    "sdunet": lambda kw: unet.build(_with(unet.UNetConfig.sd_unet(), kw)),
    "clip": lambda kw: clip.build(**kw),
    "clipvitb32": lambda kw: clip.build(_with(clip.CLIPConfig.vit_b_32(),
                                              kw)),
    "bloom": lambda kw: bloom.build(**kw),
    "bloom560m": lambda kw: bloom.build(_with(bloom.BloomConfig.bloom_560m(),
                                              kw)),
    "bloom7b1": lambda kw: bloom.build(_with(bloom.BloomConfig.bloom_7b1(),
                                             kw)),
    "gptneo": lambda kw: gptneo.build(**kw),
    "gptneo1p3b": lambda kw: gptneo.build(
        _with(gptneo.GPTNeoConfig.neo_1p3b(), kw)),
    "gptneo2p7b": lambda kw: gptneo.build(
        _with(gptneo.GPTNeoConfig.neo_2p7b(), kw)),
    # "gpt-neo-1.3b" / "gpt-neo-2.7b" as written (no GPT-Neo 13b or 27b
    # exists to collide with, unlike "opt-1.3b" and "opt-13b")
    "gptneo13b": lambda kw: gptneo.build(
        _with(gptneo.GPTNeoConfig.neo_1p3b(), kw)),
    "gptneo27b": lambda kw: gptneo.build(
        _with(gptneo.GPTNeoConfig.neo_2p7b(), kw)),
    "gptj": lambda kw: gptj.build(**kw),
    "gptj6b": lambda kw: gptj.build(_with(gptj.GPTJConfig.gptj_6b(), kw)),
    "gptneox": lambda kw: gptneox.build(**kw),
    "gptneox20b": lambda kw: gptneox.build(
        _with(gptneox.GPTNeoXConfig.neox_20b(), kw)),
    "pythia160m": lambda kw: gptneox.build(
        _with(gptneox.GPTNeoXConfig.pythia_160m(), kw)),
    "opt": lambda kw: opt.build(**kw),
    "opt125m": lambda kw: opt.build(_with(opt.OPTConfig.opt_125m(), kw)),
    "opt350m": lambda kw: opt.build(_with(opt.OPTConfig.opt_350m(), kw)),
    # 1p3b/2p7b spelling (like gptneo1p3b): "opt-1.3b" would normalize to
    # the same key as "opt-13b"
    "opt1p3b": lambda kw: opt.build(_with(opt.OPTConfig.opt_1_3b(), kw)),
    "opt2p7b": lambda kw: opt.build(_with(opt.OPTConfig.opt_2_7b(), kw)),
    "opt6p7b": lambda kw: opt.build(_with(opt.OPTConfig.opt_6_7b(), kw)),
    "opt13b": lambda kw: opt.build(_with(opt.OPTConfig.opt_13b(), kw)),
    "opt30b": lambda kw: opt.build(_with(opt.OPTConfig.opt_30b(), kw)),
    "opt66b": lambda kw: opt.build(_with(opt.OPTConfig.opt_66b(), kw)),
}


def get_model(name: str, **kwargs):
    """A model by name (``models/__init__.py:64``): case, ``-``, ``_`` and
    ``.`` are ignored (``"llama-3-8b"`` is ``llama38b``); keyword arguments
    override the named config's fields."""
    key = name.lower().replace("-", "").replace("_", "").replace(".", "")
    if key not in _NAMED:
        raise ValueError(
            f"unknown model {name!r}; known: {sorted(_NAMED)} "
            f"(or call models.<family>.build(config) directly)")
    return _NAMED[key](kwargs)
