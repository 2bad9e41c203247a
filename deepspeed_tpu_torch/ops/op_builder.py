"""Build the port's native code into shared libraries with a plain C
interface, and load them with ``ctypes``: the CUDA kernels with ``nvcc``
(:class:`CUDAOpBuilder`) and the host C++ of the offload tiers with ``g++``
(:class:`HostOpBuilder`).

The counterpart of ``deepspeed_tpu/ops/op_builder.py`` (host C++ through
g++): sources live in ``ops/csrc/``; a library is compiled at first use
(the CUDA ones for Hopper, ``sm_90a``) into ``build/deepspeed_tpu_torch/``
at the root of the checkout, named by a hash of its sources and flags, so a
changed source rebuilds and an unchanged one loads the library already
there.  Nothing is compiled when a module is imported, and a failed build
raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
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
#: the JAX package's g++ flags (``deepspeed_tpu/ops/op_builder.py:79-80``),
#: so the two host libraries compute the same bits
HOST_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
              "-fopenmp"]


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

    def flags(self) -> List[str]:
        return NVCC_FLAGS

    def compiler(self) -> str:
        return nvcc_path()

    def _hash_extra(self) -> str:
        return ""

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags()).encode())
        for src in self.sources:
            h.update(src.read_bytes())
        h.update(self._hash_extra().encode())
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
        cmd = [self.compiler(), *self.flags(), "-o", tmp,
               *[str(s) for s in self.sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed building {self.name} ({' '.join(cmd)}):\n"
                f"{self.build_log}")
        os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
            return self._lib


def _host_id() -> str:
    """The CPU's model and feature flags: ``-march=native`` output is
    specific to the host, so a build directory shared by two kinds of
    machine must not serve one the other's library (the JAX package's
    ``OpBuilder._host_id``)."""
    ident = platform.machine()
    seen = set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features") and \
                        key not in seen:
                    seen.add(key)
                    ident += line
                    if len(seen) == 2:
                        break
    except OSError:
        pass
    return ident


class HostOpBuilder(CUDAOpBuilder):
    """A host library built with ``g++`` and :data:`HOST_FLAGS` (plus
    ``extra_flags``, e.g. ``-pthread``), named by a hash that also covers
    the host's CPU (``-march=native``)."""

    def __init__(self, name: str, sources: List[str],
                 extra_flags: List[str] = ()):
        super().__init__(name, sources)
        self.extra_flags = list(extra_flags)

    def flags(self) -> List[str]:
        return HOST_FLAGS + self.extra_flags

    def compiler(self) -> str:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the port's host C++ (the CPU "
                               "optimizers, async I/O) is built from source "
                               "at first use")
        return gxx

    def _hash_extra(self) -> str:
        return _host_id()


_BUILDERS: Dict[str, CUDAOpBuilder] = {}


def builder(name: str, sources: List[str]) -> CUDAOpBuilder:
    """The process-wide builder for ``name`` (one library load each)."""
    if name not in _BUILDERS:
        _BUILDERS[name] = CUDAOpBuilder(name, sources)
    return _BUILDERS[name]


def host_builder(name: str, sources: List[str],
                 extra_flags: List[str] = ()) -> HostOpBuilder:
    """The process-wide host-library builder for ``name``."""
    if name not in _BUILDERS:
        _BUILDERS[name] = HostOpBuilder(name, sources, extra_flags)
    return _BUILDERS[name]
