"""Build the port's CUDA kernels with ``nvcc`` into a shared library with a
plain C interface, and load it with ``ctypes``.

The counterpart of ``deepspeed_tpu/ops/op_builder.py`` (host C++ through
g++): sources live in ``ops/csrc/``; the library is compiled for Hopper
(``sm_90a``) at first use into ``build/deepspeed_tpu_torch/`` at the root
of the checkout, named by a hash of its source and flags, so a changed
source rebuilds and an unchanged one loads the library already there.
Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "deepspeed_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the ``PATH`` or ``/usr/local/cuda``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from source at first use")


class CUDAOpBuilder:
    """One shared library from ``sources`` (file names under ``csrc/``).
    ``load()`` builds it when missing and returns the ``ctypes.CDLL``;
    ``build_log`` holds nvcc's output of the last build (with ptxas'
    register and shared-memory report), empty when the library was already
    there."""

    def __init__(self, name: str, sources: List[str]):
        self.name = name
        self.sources = [CSRC / s for s in sources]
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources:
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               *[str(s) for s in self.sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {self.name} ({' '.join(cmd)}):\n"
                f"{self.build_log}")
        os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
            return self._lib


_BUILDERS: Dict[str, CUDAOpBuilder] = {}


def builder(name: str, sources: List[str]) -> CUDAOpBuilder:
    """The process-wide builder for ``name`` (one library load each)."""
    if name not in _BUILDERS:
        _BUILDERS[name] = CUDAOpBuilder(name, sources)
    return _BUILDERS[name]
