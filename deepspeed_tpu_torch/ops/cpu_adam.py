"""DeepSpeedCPUAdam — host-memory Adam, AdamW and Adagrad for the optimizer
state the offload engine keeps on the host.

The port's copy of ``deepspeed_tpu/ops/cpu_adam.py`` (reference
``deepspeed/ops/adam/cpu_adam.py`` over ``csrc/adam/cpu_adam.cpp``): the
state is flat, contiguous float32 CPU buffers (torch tensors, or numpy
arrays, e.g. views of them) and the update is the OpenMP/SIMD C++ library
``ops/csrc/cpu_adam.cpp``, built with g++ at first use
(``op_builder.HostOpBuilder``).  The JAX package falls back to numpy when
there is no toolchain; the port does not: a failed build raises with g++'s
output.

Beside each host function is its plain PyTorch version (``*_plain``), the
same arithmetic for the tests; the engines never call those.

``out16`` (a ``uint16`` / ``int16`` / ``bfloat16`` buffer of the same
length) makes a step also write each updated weight as bf16, rounded to
nearest even as ``Tensor.to(torch.bfloat16)`` rounds, in the same pass.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from .op_builder import host_builder

Buffer = Union[np.ndarray, torch.Tensor]

_LIB = None


def _lib():
    """The bound host library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = host_builder("cpu_adam", ["cpu_adam.cpp"]).load()
        i64, vp, f32, c_int = (ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_float, ctypes.c_int)
        adam = [vp, vp, vp, vp, i64, f32, f32, f32, f32, f32, i64, c_int,
                c_int]
        lib.ds_adam_step.argtypes = adam
        lib.ds_adam_step.restype = None
        lib.ds_adam_step_bf16.argtypes = adam + [vp]
        lib.ds_adam_step_bf16.restype = None
        lib.ds_adagrad_step.argtypes = [vp, vp, vp, i64, f32, f32, f32]
        lib.ds_adagrad_step.restype = None
        lib.ds_adagrad_step_bf16.argtypes = [vp, vp, vp, i64, f32, f32, f32,
                                             vp]
        lib.ds_adagrad_step_bf16.restype = None
        lib.ds_sq_norm.argtypes = [vp, i64]
        lib.ds_sq_norm.restype = ctypes.c_double
        lib.ds_scale.argtypes = [vp, i64, f32]
        lib.ds_scale.restype = None
        lib.ds_all_finite.argtypes = [vp, i64]
        lib.ds_all_finite.restype = c_int
        lib.ds_add.argtypes = [vp, vp, i64]
        lib.ds_add.restype = None
        lib.ds_set_num_threads.argtypes = [c_int]
        lib.ds_set_num_threads.restype = None
        lib.ds_get_num_threads.argtypes = []
        lib.ds_get_num_threads.restype = c_int
        _LIB = lib
    return _LIB


def _ptr(buf: Buffer, n: int, itemsize: int = 4) -> int:
    """The address of a contiguous CPU buffer of ``n`` elements of
    ``itemsize`` bytes; raises on anything the C loops cannot take."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("host optimizer buffers must be contiguous CPU "
                             f"tensors (got {buf.device}, contiguous="
                             f"{buf.is_contiguous()})")
        size, nbytes, addr = buf.numel(), buf.element_size(), buf.data_ptr()
        ok_type = buf.dtype == torch.float32 if itemsize == 4 else \
            buf.dtype in (torch.bfloat16, torch.int16, torch.uint16)
    else:
        if not buf.flags.c_contiguous:
            raise ValueError("host optimizer buffers must be C-contiguous")
        size, nbytes, addr = buf.size, buf.itemsize, buf.ctypes.data
        ok_type = buf.dtype == np.float32 if itemsize == 4 else \
            buf.dtype in (np.uint16, np.int16)
    if not ok_type or nbytes != itemsize:
        raise ValueError(f"host optimizer buffer of dtype {buf.dtype}, "
                         f"expected {'float32' if itemsize == 4 else 'bf16 bits'}")
    if size != n:
        raise ValueError(f"host optimizer buffer of {size} elements, "
                         f"expected {n}")
    return addr


def _numel(buf: Buffer) -> int:
    return buf.numel() if isinstance(buf, torch.Tensor) else buf.size


def set_num_threads(n: int) -> None:
    """Size the OpenMP pool of the calling thread's host steps (the chip
    machine uses every core; a test worker one)."""
    _lib().ds_set_num_threads(int(n))


def get_num_threads() -> int:
    return int(_lib().ds_get_num_threads())


class DeepSpeedCPUAdam:
    """Adam/AdamW over flat fp32 host buffers.

    ``params``/``m``/``v`` are caller-owned contiguous fp32 buffers (the
    offloaded partition); ``step(grads)`` updates them in place."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 adamw_mode: bool = True):
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self._lib = _lib()

    def step(self, params: Buffer, grads: Buffer, m: Buffer, v: Buffer,
             lr: Optional[float] = None,
             out16: Optional[Buffer] = None) -> None:
        self.step_count += 1
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        n = _numel(params)
        args = (_ptr(params, n), _ptr(grads, n), _ptr(m, n), _ptr(v, n), n,
                lr, b1, b2, self.eps, self.weight_decay, self.step_count,
                int(self.bias_correction), int(self.adamw_mode))
        if out16 is None:
            self._lib.ds_adam_step(*args)
        else:
            self._lib.ds_adam_step_bf16(*args, _ptr(out16, n, 2))


class DeepSpeedCPUAdagrad:
    """Adagrad counterpart (reference csrc/adagrad/cpu_adagrad.cpp)."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self._lib = _lib()

    def step(self, params: Buffer, grads: Buffer, state: Buffer,
             lr: Optional[float] = None,
             out16: Optional[Buffer] = None) -> None:
        lr = self.lr if lr is None else lr
        n = _numel(params)
        args = (_ptr(params, n), _ptr(grads, n), _ptr(state, n), n, lr,
                self.eps, self.weight_decay)
        if out16 is None:
            self._lib.ds_adagrad_step(*args)
        else:
            self._lib.ds_adagrad_step_bf16(*args, _ptr(out16, n, 2))


def sq_norm(x: Buffer) -> float:
    """Sum of squares in float64 (its order depends on the thread count)."""
    n = _numel(x)
    return float(_lib().ds_sq_norm(_ptr(x, n), n))


def scale_(x: Buffer, scale: float) -> None:
    n = _numel(x)
    _lib().ds_scale(_ptr(x, n), n, scale)


def all_finite(x: Buffer) -> bool:
    n = _numel(x)
    return bool(_lib().ds_all_finite(_ptr(x, n), n))


def add_(acc: Buffer, x: Buffer) -> None:
    """``acc += x`` over float32 host buffers."""
    n = _numel(acc)
    _lib().ds_add(_ptr(acc, n), _ptr(x, n), n)


# ------------------------------------------------------------ plain versions
def _t(buf: Buffer) -> torch.Tensor:
    return buf if isinstance(buf, torch.Tensor) else torch.from_numpy(buf)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as the library's FMAs round (g++
    contracts these products in C++ even under ``-std=c++17``): the f32
    product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _sqrt(x) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as ``std::sqrt`` gives (torch's
    vectorized CPU sqrt is not, in a few elements in a thousand)."""
    return x.double().sqrt().float()


@torch.no_grad()
def adam_step_plain(params: Buffer, grads: Buffer, m: Buffer, v: Buffer,
                    step: int, lr: float, betas=(0.9, 0.999),
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    bias_correction: bool = True,
                    adamw_mode: bool = True) -> None:
    """:meth:`DeepSpeedCPUAdam.step` in PyTorch (``step`` is the count
    after this update), in place, with the compiled loop's roundings:
    ``m = fma(b1, m, (1 - b1) g)``, ``v = fma(b2, v, (1 - b2) g g)``, ``p =
    fma(decay, p, -(lr / bc1) (m / (sqrt(v) / sqrt(bc2) + eps)))``."""
    p, g, m, v = _t(params), _t(grads), _t(m), _t(v)
    f32 = np.float32
    one, b1, b2 = f32(1.0), f32(betas[0]), f32(betas[1])
    lr32, wd = f32(lr), f32(weight_decay)
    bc1 = one - b1 ** f32(step) if bias_correction else one
    bc2 = one - b2 ** f32(step) if bias_correction else one
    step_size = float(lr32 / bc1)
    bc2_sqrt = float(np.sqrt(f32(bc2)))
    decay = float(one - lr32 * wd) if (adamw_mode and wd > 0) else 1.0

    def full(x):
        return torch.full_like(p, float(x))

    if not adamw_mode and wd > 0:
        g = _fma(full(wd), p, g)
    mi = _fma(full(b1), m, float(one - b1) * g)
    vi = _fma(full(b2), v, (float(one - b2) * g) * g)
    m.copy_(mi)
    v.copy_(vi)
    denom = _sqrt(vi) / bc2_sqrt + float(f32(eps))
    p.copy_(_fma(full(decay), p, -((mi / denom) * step_size)))


@torch.no_grad()
def adagrad_step_plain(params: Buffer, grads: Buffer, state: Buffer,
                       lr: float, eps: float = 1e-10,
                       weight_decay: float = 0.0) -> None:
    """:meth:`DeepSpeedCPUAdagrad.step` in PyTorch, in place."""
    p, g, s = _t(params), _t(grads), _t(state)
    g = _fma(torch.full_like(p, float(np.float32(weight_decay))), p, g)
    si = _fma(g, g, s)
    s.copy_(si)
    p.copy_(p - (float(np.float32(lr)) * g) / (_sqrt(si) + float(
        np.float32(eps))))


def sq_norm_plain(x: Buffer) -> float:
    t = _t(x).double()
    return float(torch.dot(t, t))
