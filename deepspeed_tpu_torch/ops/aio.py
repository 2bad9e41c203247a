"""Async file I/O for the NVMe offload tier.

The port's copy of ``deepspeed_tpu/ops/aio.py`` (reference
``csrc/aio/py_lib/deepspeed_py_aio_handle.cpp``: an ``aio_handle`` with
``async_pread`` / ``async_pwrite`` / ``wait`` used by
``runtime/swap_tensor/*``).  The backend is the C++ library
``ops/csrc/aio.cpp`` (io_uring, or a worker-thread pool where io_uring is
refused), built with g++ at first use; unlike the JAX package there is no
synchronous Python fallback: a failed build raises.

Buffers are contiguous CPU tensors or numpy arrays; the handle keeps a
reference to each until ``wait`` joins its operation.  Submissions return
an **op ticket**; :meth:`AsyncIOHandle.wait_statuses` reports each
ticket's success (the native library counts failures per batch, so any
failure marks the whole batch).  :func:`swap_chain_write` /
:func:`swap_chain_read` submit a chain of blocks and wait once (the NVMe KV
tier of ``ROADMAP.md`` Queue A 9 will use them).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from .op_builder import host_builder

__all__ = ["AsyncIOHandle", "swap_chain_write", "swap_chain_read"]

Buffer = Union[np.ndarray, torch.Tensor]

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = host_builder("aio", ["aio.cpp"], ["-pthread"]).load()
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.ds_aio_handle_new.argtypes = [ctypes.c_int]
        lib.ds_aio_handle_new.restype = vp
        lib.ds_aio_handle_free.argtypes = [vp]
        lib.ds_aio_handle_free.restype = None
        lib.ds_aio_pread.argtypes = [vp, ctypes.c_char_p, vp, i64, i64]
        lib.ds_aio_pread.restype = None
        lib.ds_aio_pwrite.argtypes = [vp, ctypes.c_char_p, vp, i64, i64]
        lib.ds_aio_pwrite.restype = None
        lib.ds_aio_wait.argtypes = [vp]
        lib.ds_aio_wait.restype = i64
        lib.ds_aio_backend.argtypes = [vp]
        lib.ds_aio_backend.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _addr_nbytes(buf: Buffer):
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("aio buffers must be contiguous CPU tensors")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not buf.flags.c_contiguous:
        raise ValueError("aio buffers must be C-contiguous")
    return buf.ctypes.data, buf.nbytes


class AsyncIOHandle:
    """Submit async reads/writes of host buffers against files; ``wait()``
    joins.  ``wait()`` blocks until all submitted ops complete and returns
    the number of failures since the last wait; every submission returns a
    monotonically increasing op ticket."""

    def __init__(self, num_threads: int = 8):
        self._lib = _lib()
        self._handle = self._lib.ds_aio_handle_new(num_threads)
        self._inflight: List[Buffer] = []   # alive until wait()
        self._ops: List[int] = []           # tickets since the last wait
        self._next_op = 0

    @property
    def backend(self) -> str:
        """"io_uring" (kernel-async ring) or "threads" (worker pool)."""
        return "io_uring" if self._lib.ds_aio_backend(self._handle) else \
            "threads"

    def _submit(self, fn, buf: Buffer, path: str, offset: int) -> int:
        if self._handle is None:
            raise RuntimeError("AsyncIOHandle used after close()")
        addr, nbytes = _addr_nbytes(buf)
        t = self._next_op
        self._next_op += 1
        self._ops.append(t)
        self._inflight.append(buf)
        fn(self._handle, path.encode(), addr, nbytes, int(offset))
        return t

    def async_pread(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pread, buf, path, offset)

    def async_pwrite(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pwrite, buf, path, offset)

    def wait(self) -> int:
        """Block until all submitted ops finish; returns the failure
        count."""
        self._ops.clear()
        n = int(self._lib.ds_aio_wait(self._handle))
        self._inflight.clear()
        return n

    def wait_statuses(self) -> Dict[int, bool]:
        """Block until all submitted ops finish; ``{ticket: ok}`` for every
        op submitted since the last wait (any failure in the batch marks
        every op of it failed: the library counts failures per batch)."""
        ops, self._ops = self._ops, []
        n = int(self._lib.ds_aio_wait(self._handle))
        self._inflight.clear()
        return {t: n == 0 for t in ops}

    def close(self) -> None:
        if self._handle is not None:
            self.wait()
            self._lib.ds_aio_handle_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()


def swap_chain_write(handle: AsyncIOHandle, path: str,
                     bufs: Sequence[Buffer],
                     offsets: Sequence[int]) -> List[bool]:
    """Write a chain of block buffers at the given file offsets; one
    submit per block, ONE wait for the batch; per-block status aligned to
    the input order."""
    tickets = [handle.async_pwrite(b, path, int(off))
               for b, off in zip(bufs, offsets)]
    statuses = handle.wait_statuses()
    return [statuses.get(t, False) for t in tickets]


def swap_chain_read(handle: AsyncIOHandle, path: str,
                    bufs: Sequence[Buffer],
                    offsets: Sequence[int]) -> List[bool]:
    """Read a chain of block buffers from the given file offsets into
    preallocated ``bufs``; one wait for the batch; per-block status aligned
    to the input order (``False``: do not trust that buffer's bytes)."""
    tickets = [handle.async_pread(b, path, int(off))
               for b, off in zip(bufs, offsets)]
    statuses = handle.wait_statuses()
    return [statuses.get(t, False) for t in tickets]
