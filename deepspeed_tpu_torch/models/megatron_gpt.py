"""Megatron-LM GPT checkpoints onto the GPT-2 family — the PyTorch port
of ``deepspeed_tpu/models/megatron_gpt.py``.

Megatron GPT is the GPT-2 block (pre-LN, fused qkv, learned positions, a
tied head), so its checkpoints load into :mod:`.gpt2`'s parameter tree.
Column-parallel weights (qkv, h_to_4h) of a tensor-parallel checkpoint
merge on their rows, row-parallel ones (dense, 4h_to_h) on their columns,
the vocabulary over the ranks.  The three qkv row layouts:

 - version 0:   rows (3, np, hn) — q | k | v contiguous;
 - version 1.0: rows (np, hn, 3) — per head, the projection fastest;
 - version 2.0: rows (np, 3, hn) — per head, q | k | v.

The arithmetic is numpy on the host; the tree comes back as float32 CPU
tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .common import to_np
from .gpt2 import GPT2Config

Params = Dict[str, Any]


def _deinterleave_qkv(qkv_rows: np.ndarray, num_heads: int,
                      ckpt_version: float) -> np.ndarray:
    """``[3h, h]`` Megatron rows of any version -> q | k | v contiguous
    (``megatron_gpt.py:37``)."""
    three_h, h = qkv_rows.shape
    hn = three_h // (3 * num_heads)
    if ckpt_version == 0:
        return qkv_rows
    if ckpt_version == 1.0:
        x = qkv_rows.reshape(num_heads, hn, 3, h)
        return x.transpose(2, 0, 1, 3).reshape(three_h, h)
    if ckpt_version == 2.0:
        x = qkv_rows.reshape(num_heads, 3, hn, h)
        return x.transpose(1, 0, 2, 3).reshape(three_h, h)
    raise ValueError(f"unsupported Megatron checkpoint version {ckpt_version}")


def _deinterleave_qkv_bias(b: np.ndarray, num_heads: int,
                           ckpt_version: float) -> np.ndarray:
    three_h = b.shape[0]
    hn = three_h // (3 * num_heads)
    if ckpt_version == 0:
        return b
    if ckpt_version == 1.0:
        return b.reshape(num_heads, hn, 3).transpose(2, 0, 1).reshape(three_h)
    if ckpt_version == 2.0:
        return b.reshape(num_heads, 3, hn).transpose(1, 0, 2).reshape(three_h)
    raise ValueError(f"unsupported Megatron checkpoint version {ckpt_version}")


def merge_tp_qkv(shards: Sequence[np.ndarray], num_heads: int,
                 ckpt_version: float) -> np.ndarray:
    """Per-rank qkv row shards merged (``megatron_gpt.py:67``): version 0
    concatenates each projection's rows, 1.0 / 2.0 whole shards (their
    rows are interleaved by head)."""
    if ckpt_version == 0:
        per = [np.split(s, 3, axis=0) for s in shards]
        return np.concatenate([np.concatenate([p[i] for p in per], axis=0)
                               for i in range(3)], axis=0)
    return np.concatenate(list(shards), axis=0)


_EMB_PREFIXES = ("", "embedding.", "model.", "model.language_model.",
                 "model.language_model.embedding.", "transformer.",
                 "encoder.", "model.language_model.transformer.",
                 "model.language_model.encoder.")


def _get_any(sd, name):
    for p in _EMB_PREFIXES:
        if p + name in sd:
            return to_np(sd[p + name])
    raise KeyError(f"{name} (have: {sorted(sd)[:8]}...)")


def config_from_state_dicts(shards: Sequence[Dict[str, Any]],
                            max_seq_len: Optional[int] = None,
                            num_heads: Optional[int] = None) -> GPT2Config:
    """A GPT2Config from Megatron GPT tensor-parallel state dicts (the
    vocabulary is split over the ranks, so every shard counts).  Megatron
    stores no head count: 64-wide heads unless ``num_heads`` says."""
    sd = shards[0]
    vocab = sum(_get_any(s, "word_embeddings.weight").shape[0]
                for s in shards)
    wpe = _get_any(sd, "position_embeddings.weight")
    n_layers = 1 + max(
        int(k.split("layers.")[1].split(".")[0])
        for k in sd if ".layers." in k or k.startswith("layers."))
    d = wpe.shape[1]
    return GPT2Config(vocab_size=vocab,
                      max_seq_len=max_seq_len or wpe.shape[0],
                      num_layers=n_layers,
                      num_heads=num_heads or max(1, d // 64),
                      hidden_size=d)


def config_from_state_dict(sd: Dict[str, Any],
                           max_seq_len: Optional[int] = None,
                           num_heads: Optional[int] = None) -> GPT2Config:
    """:func:`config_from_state_dicts` of one (merged) state dict."""
    return config_from_state_dicts([sd], max_seq_len=max_seq_len,
                                   num_heads=num_heads)


def from_megatron_state_dicts(cfg: GPT2Config, shards: List[Dict[str, Any]],
                              ckpt_version: float = 0) -> Params:
    """Megatron tensor-parallel state dicts (one a rank; one for an
    unpartitioned checkpoint) merged into the GPT-2 parameter tree
    (``megatron_gpt.py:122``), float32 CPU tensors."""
    l = cfg.num_layers

    def merged(name, i, axis=None, qkv=False):
        parts = [_get_any(sd, f"layers.{i}.{name}") for sd in shards]
        if qkv:
            return merge_tp_qkv(parts, cfg.num_heads, ckpt_version)
        if axis is None or len(parts) == 1:
            return parts[0]
        return np.concatenate(parts, axis=axis)

    def stack(fn):
        return torch.from_numpy(np.ascontiguousarray(
            np.stack([fn(i) for i in range(l)])))

    def one(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    wte = np.concatenate([_get_any(sd, "word_embeddings.weight")
                          for sd in shards], axis=0)
    return {
        "wte": one(wte[:cfg.vocab_size]),
        "wpe": one(_get_any(shards[0], "position_embeddings.weight")),
        "blocks": {
            "ln1_scale": stack(lambda i: merged("input_layernorm.weight", i)),
            "ln1_bias": stack(lambda i: merged("input_layernorm.bias", i)),
            # torch [out, in] -> [in, out]
            "qkv_w": stack(lambda i: _deinterleave_qkv(
                merged("attention.query_key_value.weight", i, qkv=True),
                cfg.num_heads, ckpt_version).T),
            "qkv_b": stack(lambda i: _deinterleave_qkv_bias(
                merge_tp_qkv([_get_any(sd, f"layers.{i}.attention."
                                       "query_key_value.bias")[:, None]
                              for sd in shards], cfg.num_heads,
                             ckpt_version)[:, 0],
                cfg.num_heads, ckpt_version)),
            "o_w": stack(lambda i: merged("attention.dense.weight", i,
                                          axis=1).T),
            "o_b": stack(lambda i: merged("attention.dense.bias", i)),
            "ln2_scale": stack(
                lambda i: merged("post_attention_layernorm.weight", i)),
            "ln2_bias": stack(
                lambda i: merged("post_attention_layernorm.bias", i)),
            "fc_w": stack(lambda i: merged("mlp.dense_h_to_4h.weight", i,
                                           axis=0).T),
            "fc_b": stack(lambda i: merged("mlp.dense_h_to_4h.bias", i,
                                           axis=0)),
            "proj_w": stack(lambda i: merged("mlp.dense_4h_to_h.weight", i,
                                             axis=1).T),
            "proj_b": stack(lambda i: merged("mlp.dense_4h_to_h.bias", i)),
        },
        "lnf_scale": one(_get_any(shards[0], "final_layernorm.weight")),
        "lnf_bias": one(_get_any(shards[0], "final_layernorm.bias")),
    }


def _flatten(prefix: str, d: Dict[str, Any], out: Dict[str, Any]):
    for k, v in d.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{k}.", v, out)
        else:
            out[f"{prefix}{k}"] = v
    return out


def load(ckpt_files: List[str], cfg: Optional[GPT2Config] = None,
         ckpt_version: Optional[float] = None):
    """Megatron GPT checkpoint file(s), one a tensor-parallel rank ->
    ``(model, params)`` (``megatron_gpt.py:190``).  Takes raw state dicts
    or Megatron's wrapper ``{"model": ..., "checkpoint_version": ...}``
    (nested dicts flattened); the files are torch pickles written by
    Megatron, read with ``weights_only=False``."""
    from . import gpt2

    raw = [torch.load(f, map_location="cpu", weights_only=False)
           for f in ckpt_files]
    sds = []
    ver = ckpt_version
    for r in raw:
        if isinstance(r, dict) and isinstance(r.get("model"), dict):
            if ver is None and "checkpoint_version" in r:
                ver = float(r["checkpoint_version"])
            sd = r["model"]
            sds.append(_flatten("", sd.get("language_model", sd), {}))
        else:
            sds.append(r)
    ver = 0 if ver is None else ver
    cfg = cfg or config_from_state_dicts(sds)
    return gpt2.build(cfg), from_megatron_state_dicts(cfg, sds,
                                                      ckpt_version=ver)
