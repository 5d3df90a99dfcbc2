"""ssd_scan — the Mamba2 SSD entry point, dispatched by tensor device (see
:mod:`repro_torch.kernels` for ``impl``).

:func:`ssd_scan` takes the model's layout, folds ``dt`` into ``xdt = x *
dt`` and ``dA = dt * A`` as the reference's entry point does, and runs the
CUDA kernel (``ssd_scan.cu``) for tensors on a GPU and the chunked
algorithm (:func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_folded`,
the reference model's own arithmetic) for tensors on the CPU.
:func:`ssd_scan_kernel` is the same entry point on the kernel's layout.
The kernel is forward-only, as the TPU kernel is: for inputs
that require grad (with grad enabled) the wrapper raises on a GPU.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, count_launch, launch, use_kernel
from .ref import ssd_chunked_folded

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the largest head dim (P) and state size (N) the kernel takes
MAX_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not hasattr(lib, "_typed"):
        for name in ("ssd_scan_f32", "ssd_scan_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 6 + [_I64] * 7 + [_P]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             impl: str = "auto"):
    """Model layout: x (B, S, H, P), dt (B, S, H), A (H,), B/C (B, S, G, N)
    -> y (B, S, H, P) in x's dtype, final_state (B, H, P, N) float32.

    ``chunk`` is capped at S, as the reference's kernel caps it; S must be
    a multiple of it (``ValueError`` otherwise)."""
    xdt = (x * dt[..., None]).transpose(1, 2).contiguous()  # (B, H, S, P)
    dA = (dt * A).transpose(1, 2).contiguous()              # (B, H, S)
    y, st = ssd_scan_kernel(xdt, dA, B.transpose(1, 2).contiguous(),
                            C.transpose(1, 2).contiguous(), chunk=chunk,
                            impl=impl)
    return y.transpose(1, 2), st


def ssd_scan_kernel(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, chunk: int = 128,
                    impl: str = "auto"):
    """Kernel layout: xdt (B, H, S, P), dA (B, H, S), B/C (B, G, S, N),
    contiguous -> y (B, H, S, P) in xdt's dtype, final_state (B, H, P, N)
    float32.

    xdt, B and C share float32 or bfloat16; dA is float32 or their dtype
    (read as float32 either way).  On the CPU, or with ``impl="ref"``, it
    runs :func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_folded`."""
    chunk = min(chunk, xdt.shape[2])
    if not use_kernel(impl, xdt):
        return ssd_chunked_folded(xdt, dA, B, C, chunk)
    if xdt.ndim != 4 or dA.ndim != 3 or B.ndim != 4 or C.shape != B.shape:
        raise ValueError(f"xdt must be (B, H, S, P), dA (B, H, S) and B, C "
                         f"(B, G, S, N), got {tuple(xdt.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    if dA.shape != (b, H, S) or B.shape[0] != b or B.shape[2] != S:
        raise ValueError(f"dA {tuple(dA.shape)} and B {tuple(B.shape)} do "
                         f"not fit xdt {tuple(xdt.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"the groups G = {G} must divide the heads H = {H}")
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"the kernel takes head dim P and state N from 1 "
                         f"to {MAX_DIM}, got P = {P}, N = {N}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    if xdt.dtype not in (torch.float32, torch.bfloat16) \
            or B.dtype != xdt.dtype or C.dtype != xdt.dtype \
            or dA.dtype not in (torch.float32, xdt.dtype):
        raise TypeError(f"xdt, B, C must share float32|bfloat16 and dA be "
                        f"float32 or theirs, got {xdt.dtype}, {B.dtype}, "
                        f"{C.dtype}, {dA.dtype}")
    if any(t.device != xdt.device for t in (dA, B, C)):
        raise ValueError(f"xdt, dA, B, C on {xdt.device}, {dA.device}, "
                         f"{B.device}, {C.device}")
    if not all(t.is_contiguous() for t in (xdt, dA, B, C)):
        raise ValueError("the kernel takes contiguous xdt, dA, B, C")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xdt, dA, B, C)):
        raise NotImplementedError(
            "the CUDA ssd_scan kernel is forward-only; run it under "
            "torch.inference_mode() or torch.no_grad()")
    dA = dA.float()                  # exact for a bfloat16 dA
    y = torch.empty_like(xdt)
    st = torch.empty((b, H, P, N), dtype=torch.float32, device=xdt.device)
    lib = _lib()
    fn = lib.ssd_scan_f32 if xdt.dtype == torch.float32 else lib.ssd_scan_bf16
    launch(lib, fn, "ssd_scan", xdt.device, xdt.data_ptr(), dA.data_ptr(),
           B.data_ptr(), C.data_ptr(), y.data_ptr(), st.data_ptr(), b, H, G,
           S, P, N, chunk)
    count_launch("ssd_scan", (b, H, G, S, P, N, chunk))
    return y, st
