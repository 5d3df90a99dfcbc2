"""flash_attention — the attention entry point, dispatched by tensor
device (see :mod:`repro_torch.kernels` for ``impl``).

The CUDA kernel (``flash_attention.cu``) is forward-only, as the TPU
kernel is: for inputs that require grad (with grad enabled) the wrapper
raises on a GPU rather than return an output that cannot backpropagate.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, count_launch, launch, use_kernel
from .ref import flash_attention_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 192, 256)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not hasattr(lib, "_typed"):
        for name in ("flash_attention_f32", "flash_attention_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 4 + [_I64] * 6 + [ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.flash_attention_resources.argtypes = [ctypes.c_int, _I64,
                                                  ctypes.POINTER(_I64)]
        lib.flash_attention_resources.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh) -> (B, H, Sq, Dh) in q's
    dtype; GQA when Hkv divides H; causal masking end-aligned (query i
    sees keys j <= i + Sk - Sq)."""
    if not use_kernel(impl, q):
        return flash_attention_ref(q, k, v, causal=causal)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, Dh) and k, v (B, Hkv, Sk, "
                         f"Dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or Hkv == 0 or H % Hkv:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}: same B and Dh, Hkv dividing H")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head dims {HEAD_DIMS}, "
                         f"got {Dh}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32|bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the CUDA flash-attention kernel is forward-only; run it under "
            "torch.inference_mode() or torch.no_grad()")
    # both instances copy 16-byte pieces: a view that starts off such a
    # boundary is copied to fresh (aligned) memory first
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _lib()
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    launch(lib, fn, "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Sk, Dh, int(causal))
    count_launch("flash_attention", (B, H, Hkv, Sq, Sk, Dh))
    return out


def kernel_resources(dtype: torch.dtype, Dh: int) -> dict:
    """What the instance for (``dtype``, ``Dh``) takes on the current CUDA
    device: dynamic shared memory, registers and local (spill) bytes a
    thread, and the blocks an SM holds at once."""
    out = (_I64 * 4)()
    lib = _lib()
    err = lib.flash_attention_resources(int(dtype == torch.bfloat16), Dh,
                                        out)
    if err:
        raise RuntimeError(f"flash_attention_resources failed: "
                           f"{lib.error_string(err).decode()} ({err})")
    return dict(zip(("smem_bytes", "registers", "local_bytes",
                     "blocks_per_sm"), out))
