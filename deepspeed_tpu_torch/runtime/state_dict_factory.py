"""Checkpoint state-dict loading: HuggingFace shards and tensor-parallel
merge / split — the PyTorch port of
``deepspeed_tpu/runtime/state_dict_factory.py`` (reference
``runtime/state_dict_factory.py:20`` ``SDLoaderFactory``, ``:214``
``MegatronSDLoader``).

The on-disk formats are HuggingFace's: ``pytorch_model*.bin`` (torch
pickles, read with ``torch.load(weights_only=True)``) and
``*.safetensors``, parsed here without the ``safetensors`` package (an
8-byte little-endian header length, a JSON header of each tensor's
``dtype``, ``shape`` and ``data_offsets``, then the raw bytes;
:func:`read_safetensors` / :func:`write_safetensors`).  ``config.json`` is
read with ``json``; ``module_inject``'s policies take it as a dict, so
nothing here needs ``transformers``.  The merge / split helpers work on
numpy arrays along a named dimension, for checkpoints written at another
tensor-parallel degree.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as a dict of CPU tensors (BF16 as
    ``torch.bfloat16``), in the header's order; ``__metadata__`` is
    skipped."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        buf = bytearray(data[begin:end])
        t = torch.frombuffer(buf, dtype=dtype) if buf else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (CPU tensors or numpy arrays) as a
    ``.safetensors`` file: the layout :func:`read_safetensors` reads and
    the ``safetensors`` package writes (header padded with spaces to a
    multiple of 8 bytes)."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name, t in tensors.items():
        t = torch.as_tensor(t).detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _load_torch_bin(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def get_sd_loader(ckpt_list, sd_type: str = "Megatron", version=None):
    """SDLoaderFactory dispatch (``state_dict_factory.py:42``): a loader
    callable for Megatron checkpoints, one file a tensor-parallel rank,
    merged by :mod:`..models.megatron_gpt` (all three qkv layouts)."""
    if str(sd_type).lower() != "megatron":
        raise ValueError(f"unsupported sd_type {sd_type!r} (Megatron only; "
                         "HF checkpoints load via load_hf_weights)")
    from ..models import megatron_gpt

    def load(cfg=None):
        return megatron_gpt.load(list(ckpt_list), cfg=cfg,
                                 ckpt_version=version)

    return load


def get_sd_loader_json(ckpt_dir: str) -> List[str]:
    """The shard files of a checkpoint directory (``:62``): those of an HF
    index json's ``weight_map``, a single ``model.safetensors`` /
    ``pytorch_model.bin``, or every ``.bin`` / ``.safetensors`` / ``.pt``
    file; a file path is its own list."""
    if os.path.isfile(ckpt_dir):
        return [ckpt_dir]
    for index_name in ("model.safetensors.index.json",
                       "pytorch_model.bin.index.json"):
        idx = os.path.join(ckpt_dir, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            return sorted({os.path.join(ckpt_dir, v)
                           for v in weight_map.values()})
    for single in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(ckpt_dir, single)
        if os.path.exists(p):
            return [p]
    shards = sorted(
        os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
        if f.endswith((".bin", ".safetensors", ".pt")))
    if not shards:
        raise FileNotFoundError(f"no checkpoint shards found in {ckpt_dir}")
    return shards


def load_state_dict(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """Every shard of an HF-style checkpoint in one dict of CPU tensors in
    their stored dtypes (``:90``; the JAX function gives numpy arrays,
    which have no bfloat16)."""
    sd: Dict[str, torch.Tensor] = {}
    for path in get_sd_loader_json(ckpt_dir):
        part = read_safetensors(path) if path.endswith(".safetensors") \
            else _load_torch_bin(path)
        sd.update(part)
    return sd


# ------------------------------------------------------------ TP merge/split
def merge_tp_shards(shards: List[np.ndarray], dim: int) -> np.ndarray:
    """Per-rank tensor-parallel shards merged into the full tensor
    (reference ``MegatronSDLoader.merge_state_dict``, ``:214``)."""
    if len(shards) == 1:
        return shards[0]
    return np.concatenate(shards, axis=dim)


def merge_qkv_shards(shards: List[np.ndarray], dim: int) -> np.ndarray:
    """Shards of a fused qkv tensor merged: each rank holds ``[q_r; k_r;
    v_r]`` along ``dim``, so the merge splits each in three and joins q,
    k and v separately."""
    if len(shards) == 1:
        return shards[0]
    parts = [np.split(s, 3, axis=dim) for s in shards]  # per rank: q,k,v
    return np.concatenate(
        [np.concatenate([p[i] for p in parts], axis=dim) for i in range(3)],
        axis=dim)


def split_tp_shard(tensor: np.ndarray, dim: int, ranks: int,
                   rank: Optional[int] = None):
    """A full tensor split into tensor-parallel shards (all, or
    ``rank``'s)."""
    pieces = np.split(tensor, ranks, axis=dim)
    return pieces if rank is None else pieces[rank]


def load_hf_weights(model_name_or_dir, arch_hint: Optional[str] = None):
    """One-call ingestion (``:130``): an HF checkpoint directory
    (``config.json`` read with ``json``, the weights by
    :func:`load_state_dict`) or an in-memory HF model -> ``(model,
    params)`` through the injection policies.  ``arch_hint`` names the
    architecture when ``config.json`` has none."""
    from ..module_inject.replace_policy import (as_hf_config, policy_for,
                                                replace_module)

    if hasattr(model_name_or_dir, "state_dict"):  # in-memory HF model
        return replace_module(hf_model=model_name_or_dir)

    ckpt_dir = str(model_name_or_dir)
    cfg_path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"{ckpt_dir} has no config.json; pass an HF checkpoint directory")
    with open(cfg_path) as f:
        hf_cfg = json.load(f)
    if arch_hint is not None and not hf_cfg.get("architectures"):
        hf_cfg["architectures"] = [arch_hint]
    pol = policy_for(hf_cfg)
    if pol is not None:
        # an unported family refuses before its weights are read
        pol.translate_config(as_hf_config(hf_cfg))
    return replace_module(config=hf_cfg, state_dict=load_state_dict(ckpt_dir))
