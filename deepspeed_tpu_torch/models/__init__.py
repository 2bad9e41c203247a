"""Model zoo of the PyTorch port: the families ported so far, by the JAX
package's names (``deepspeed_tpu/models/__init__.py``)."""

import dataclasses

from . import gpt2, llama, mixtral, opt


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

#: the JAX package's other names: families this port does not have yet
_LATER = ("bert", "bertbase", "bertlarge", "vae", "sdvae", "unet", "sdunet",
          "clip", "clipvitb32", "bloom", "bloom560m", "bloom7b1", "gptneo",
          "gptneo1p3b", "gptneo2p7b", "gptj", "gptj6b", "gptneox",
          "gptneox20b", "pythia160m")


def get_model(name: str, **kwargs):
    """A model by name (``models/__init__.py:64``): case, ``-``, ``_`` and
    ``.`` are ignored (``"llama-3-8b"`` is ``llama38b``); keyword arguments
    override the named config's fields."""
    key = name.lower().replace("-", "").replace("_", "").replace(".", "")
    if key in _LATER:
        raise NotImplementedError(
            f"model {name!r}: this family is not ported yet — it comes with "
            "the PyTorch port's other model families (ROADMAP.md Queue A "
            "item 7)")
    if key not in _NAMED:
        raise ValueError(
            f"unknown model {name!r}; known: {sorted(_NAMED)} "
            f"(or call models.<family>.build(config) directly)")
    return _NAMED[key](kwargs)
