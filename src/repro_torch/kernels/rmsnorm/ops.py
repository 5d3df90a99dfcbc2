"""rmsnorm — the row RMSNorm entry point, dispatched by tensor device (see
:mod:`repro_torch.kernels` for ``impl``).

The CUDA kernel (``rmsnorm.cu``) computes in float32 to the end, as the
TPU kernel does; the plain version is the model's ``layers.rmsnorm``.
The model itself calls the plain function, as the reference's does.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, count_launch, launch, use_kernel
from .ref import rmsnorm_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    if not hasattr(lib, "_typed"):
        for name in ("rmsnorm_f32", "rmsnorm_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _P, _P, _I64, _I64, ctypes.c_float, _P]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * w`` over the last axis:
    x (..., D), w (D,) -> the shape and dtype of x."""
    if not use_kernel(impl, x):
        return rmsnorm_ref(x, w, eps)
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w must be ({D},), got {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32|bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    lib = _lib()
    fn = lib.rmsnorm_f32 if x.dtype == torch.float32 else lib.rmsnorm_bf16
    launch(lib, fn, "rmsnorm", x.device, x.data_ptr(), w.data_ptr(),
           out.data_ptr(), rows, D, float(eps))
    count_launch("rmsnorm", (rows, D))
    return out
