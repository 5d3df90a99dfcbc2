"""swap_gain — the fused swap-select step, dispatched by tensor device.

``impl="auto"`` launches the CUDA kernel (``swap_select.cu``) for
tensors on a GPU and runs the plain PyTorch version (:mod:`.ref`) for
tensors on the CPU — chosen by the tensors' device and nothing else.
``impl="kernel"`` insists on the kernel; ``impl="ref"`` runs the plain
version on any device.  A kernel that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, count_launch
from ..hop_dist.ops import use_kernel
from .ref import swap_select_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = _build.load("swap_gain")
    if not hasattr(lib, "_typed"):
        for name in ("swap_select_f32", "swap_select_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 9 + [_I64, _I64, _P]
            fn.restype = ctypes.c_int
        lib.swap_select_blocks.argtypes = [_I64]
        lib.swap_select_blocks.restype = _I64
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def swap_select(M: torch.Tensor, G: torch.Tensor, contrib: torch.Tensor,
                i: torch.Tensor, n_valid, *, impl: str = "auto"):
    """Fused select step of the dense refiner for a batch of candidates.

    ``M`` (B, n, n) gathered distances per candidate, ``G`` (n, n) the
    shared guest, ``contrib`` (B, n), ``i`` (B,) int64 movers, ``n_valid``
    the live process count (an int32 tensor on the device of ``M``, or an
    int, which costs a blocking host-to-device copy per call).  Returns ``(gain, j)``: (B,) best masked gains in ``M``'s
    dtype and (B,) int64 partners, ``j == i`` for a rejected mover — see
    :func:`.ref.swap_select_ref`.
    """
    if not use_kernel(impl, M):
        return swap_select_ref(M, G, contrib, i, n_valid)
    if M.ndim != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"M must be (B, n, n), got {tuple(M.shape)}")
    B, n = M.shape[0], M.shape[1]
    if G.shape != (n, n) or contrib.shape != (B, n) or i.shape != (B,):
        raise ValueError(f"shapes G {tuple(G.shape)}, contrib "
                         f"{tuple(contrib.shape)}, i {tuple(i.shape)} do not "
                         f"match M {tuple(M.shape)}")
    if M.dtype not in (torch.float32, torch.float64) \
            or G.dtype != M.dtype or contrib.dtype != M.dtype:
        raise TypeError(f"M, G, contrib must share float32|float64, got "
                        f"{M.dtype}, {G.dtype}, {contrib.dtype}")
    if i.dtype != torch.int64:
        raise TypeError(f"movers i must be int64, got {i.dtype}")
    if not isinstance(n_valid, torch.Tensor):
        n_valid = torch.tensor([int(n_valid)], dtype=torch.int32,
                               device=M.device)
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise TypeError("n_valid must be a one-element int32 tensor")
    for t in (G, contrib, i, n_valid):
        if t.device != M.device:
            raise ValueError(f"operand on {t.device}, M on {M.device}")
    for t in (M, G, contrib, i):
        if not t.is_contiguous():
            raise ValueError("swap_select operands must be contiguous")
    lib = _lib()
    nblk = lib.swap_select_blocks(n)
    part_v = torch.empty((B, nblk), dtype=M.dtype, device=M.device)
    part_j = torch.empty((B, nblk), dtype=torch.int64, device=M.device)
    gain = torch.empty(B, dtype=M.dtype, device=M.device)
    j = torch.empty(B, dtype=torch.int64, device=M.device)
    fn = lib.swap_select_f64 if M.dtype == torch.float64 \
        else lib.swap_select_f32
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = fn(M.data_ptr(), G.data_ptr(), contrib.data_ptr(),
                 i.data_ptr(), n_valid.data_ptr(), part_v.data_ptr(),
                 part_j.data_ptr(), gain.data_ptr(), j.data_ptr(), B, n,
                 stream)
    if err:
        raise RuntimeError(f"swap_select launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
    count_launch("swap_select", (B, n))
    return gain, j
