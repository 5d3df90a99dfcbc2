"""flash_attention — the attention entry point, dispatched by tensor
device (see :mod:`repro_torch.kernels` for ``impl``).

Without grad the CUDA forward (``flash_attention.cu``) runs alone.  For
inputs that require grad (with grad enabled) the call goes through
:class:`_FlashAttention`, an ``autograd.Function`` whose forward launches
the same kernel and also keeps each row's log-sum-exp, and whose backward
launches the backward kernels (``flash_attention_bwd.cu``, on the tensor
cores: dQ with each row's l and D, then dK/dV).  The TPU kernel has no
backward; the reference trains through its plain version, which is what
the CPU path here differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, count_launch, launch, tagged, use_kernel
from .ref import flash_attention_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the head dims the kernels are built for, forward and backward
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 192, 256)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not hasattr(lib, "_typed"):
        for name in ("flash_attention_f32", "flash_attention_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 5 + [_I64] * 6 + [ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.flash_attention_resources.argtypes = [ctypes.c_int, _I64,
                                                  ctypes.POINTER(_I64)]
        lib.flash_attention_resources.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if not hasattr(lib, "_typed"):
        for name in ("flash_attention_bwd_f32", "flash_attention_bwd_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 9 + [_I64] * 6 + [ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.flash_attention_bwd_resources.argtypes = [
            ctypes.c_int, _I64, ctypes.c_int, ctypes.POINTER(_I64)]
        lib.flash_attention_bwd_resources.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh) -> (B, H, Sq, Dh) in q's
    dtype; GQA when Hkv divides H; causal masking end-aligned (query i
    sees keys j <= i + Sk - Sq)."""
    if not use_kernel(impl, q):
        return tagged("flash", flash_attention_ref, q, k, v, causal=causal)
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
        if causal and Sq > Sk:
            raise ValueError(f"causal attention with Sq {Sq} > Sk {Sk} "
                             f"leaves rows that see no key: no gradient")
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]


def _forward(q, k, v, causal: bool, with_lse: bool):
    """One launch of the forward kernel on checked inputs: (out, lse),
    lse (B, H, Sq) float32, each row's natural log-sum-exp of its scaled,
    masked scores, with ``with_lse``, else None."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    lib = _lib()
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    launch(lib, fn, "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
           B, H, Hkv, Sq, Sk, Dh, int(causal))
    count_launch("flash_attention", (B, H, Hkv, Sq, Sk, Dh))
    return out, lse


def _aligned(*ts):
    """Contiguous tensors whose data starts on a 16-byte boundary (the
    forward instances copy 16-byte pieces): a view that starts off one is
    copied to fresh memory first."""
    return tuple(t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in ts)


def _backward(q, k, v, lse, dout, causal: bool):
    """The two backward launches (dQ with the row statistics, then dK/dV)
    on the forward's inputs and log-sum-exp: (dq, dk, dv) in q's dtype."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dout, = _aligned(dout.to(q.dtype).contiguous())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    # each row's 1 / l and D, from the dQ launch for the dK/dV launch
    stats = torch.empty((B, H, Sq, 2), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    fn = (lib.flash_attention_bwd_f32 if q.dtype == torch.float32
          else lib.flash_attention_bwd_bf16)
    launch(lib, fn, "flash_attention_bwd", q.device, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
           H, Hkv, Sq, Sk, Dh, int(causal))
    count_launch("flash_attention_bwd", (B, H, Hkv, Sq, Sk, Dh))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward, keeping q, k, v and each row's log-sum-exp;
    the backward kernels for the gradients of q, k and v (the
    GQA sum over a KV head's query heads is taken inside the dK/dV
    kernel).  ``causal`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = _aligned(q, k, v)
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, lse, dout, ctx.causal)
        return dq, dk, dv, None


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


def bwd_kernel_resources(dtype: torch.dtype, Dh: int) -> dict:
    """What each backward kernel of the instance for (``dtype``, ``Dh``)
    takes on the current CUDA device, by kernel (``dq``, ``dkdv``), as
    :func:`kernel_resources` gives the forward's."""
    lib = _bwd_lib()
    res = {}
    for kernel, name in enumerate(("dq", "dkdv")):
        out = (_I64 * 4)()
        err = lib.flash_attention_bwd_resources(
            int(dtype == torch.bfloat16), Dh, kernel, out)
        if err:
            raise RuntimeError(f"flash_attention_bwd_resources failed: "
                               f"{lib.error_string(err).decode()} ({err})")
        res[name] = dict(zip(("smem_bytes", "registers", "local_bytes",
                              "blocks_per_sm"), out))
    return res
