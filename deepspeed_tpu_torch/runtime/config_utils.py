"""Config model base.

The port's copy of ``deepspeed_tpu/runtime/config_utils.py``
(``DeepSpeedConfigModel``).  The JAX package builds it on pydantic; the
machines the port runs on need not have pydantic, so this copy keeps the
same contract on the standard library alone: fields are class annotations
with defaults, :func:`Field` adds a default factory and a key alias, unknown
keys warn (or raise with ``strict=True``) and are kept as attributes, a
dict given for a field whose annotation is itself a config model builds
that model, and ``model_fields_set`` names the fields the caller gave.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any

from ..utils.logging import logger


def Field(default: Any = dataclasses.MISSING, *, alias: str = None,
          default_factory: Any = dataclasses.MISSING):
    """A field with an optional alias key (pydantic's ``Field`` subset)."""
    return dataclasses.field(default=default, default_factory=default_factory,
                             metadata={"alias": alias})


class DeepSpeedConfigModel:
    """Base for all config blocks.  Subclasses are declared with
    ``@dataclasses.dataclass(init=False)``; construction goes through this
    ``__init__`` so aliases, nesting and unknown keys behave as in the JAX
    package."""

    def __init__(self, strict: bool = False, **data):
        fields = {f.name: f for f in dataclasses.fields(self)}
        hints = typing.get_type_hints(type(self))
        by_key = dict((f.metadata.get("alias"), name)
                      for name, f in fields.items() if f.metadata.get("alias"))
        by_key.update((name, name) for name in fields)
        unknown = sorted(k for k in data if k not in by_key)
        if unknown:
            msg = f"{type(self).__name__}: unknown config keys {unknown}"
            if strict:
                raise ValueError(msg)
            logger.warning(msg)
        for name, f in fields.items():
            if f.default is not dataclasses.MISSING:
                value = f.default
            elif f.default_factory is not dataclasses.MISSING:
                value = f.default_factory()
            else:
                value = None
            setattr(self, name, value)
        self.model_fields_set = {by_key[k] for k in data if k in by_key}
        for key, value in data.items():
            name = by_key.get(key)
            if name is None:
                setattr(self, key, value)
                continue
            kind = hints.get(name)
            if isinstance(kind, type) and isinstance(value, dict) and \
                    issubclass(kind, DeepSpeedConfigModel):
                value = kind(strict=strict, **value)
            setattr(self, name, value)
