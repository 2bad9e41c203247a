"""Model zoo of the PyTorch port: the families ported so far, by the JAX
package's names (``deepspeed_tpu/models/__init__.py``)."""

import dataclasses

from . import gpt2, llama


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
}

#: the JAX package's other names: families this port does not have yet
_LATER = ("mixtral", "mixtral8x7b", "bert", "bertbase", "bertlarge", "vae",
          "sdvae", "unet", "sdunet", "clip", "clipvitb32", "bloom",
          "bloom560m", "bloom7b1", "gptneo", "gptneo1p3b", "gptneo2p7b",
          "gptj", "gptj6b", "gptneox", "gptneox20b", "pythia160m", "opt",
          "opt125m", "opt350m", "opt1p3b", "opt2p7b", "opt6p7b", "opt13b",
          "opt30b", "opt66b")


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
