"""CUDA accelerator: device resolution for the PyTorch port — the
counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py``.

The port runs on an NVIDIA GPU.  Entry points resolve their device here:
with no device given they take ``cuda`` and raise when no GPU is present,
so a run never continues on the CPU by accident; ``device="cpu"`` is the
one explicit way onto the CPU (the tests use it).
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  Raises ``RuntimeError`` when CUDA is asked for (or
    defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r} (cuda or cpu)")
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card — the label every measurement carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
