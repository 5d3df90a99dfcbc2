"""swap_gain — the gains row and the fused swap-select step, dispatched by
tensor device (see :mod:`repro_torch.kernels` for ``impl``).

Both CUDA kernels live in ``swap_select.cu``: the fused step one warp a
column, the gains row in tiles of rows with 16-byte loads where n and the
operands' addresses allow; their plain PyTorch versions are in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, count_launch, launch, use_kernel
from .ref import swap_gain_ref, swap_select_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_FLOATS = (torch.float32, torch.float64)


def _lib() -> ctypes.CDLL:
    lib = _build.load("swap_gain")
    if not hasattr(lib, "_typed"):
        for name in ("swap_select_f32", "swap_select_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 9 + [_I64, _I64, _P]
            fn.restype = ctypes.c_int
        for name in ("swap_gain_f32", "swap_gain_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 5 + [_I64, _P]
            fn.restype = ctypes.c_int
        lib.swap_select_blocks.argtypes = [_I64]
        lib.swap_select_blocks.restype = _I64
        lib._typed = True
    return lib


def swap_gain(M: torch.Tensor, G: torch.Tensor, contrib: torch.Tensor, i,
              *, impl: str = "auto") -> torch.Tensor:
    """Dense gains row of the pairwise-swap refiner for mover ``i``.

    ``M``, ``G`` (n, n), ``contrib`` (n,) in one float dtype; ``i`` an int
    or a one-element int64 tensor on ``M``'s device (an int costs a
    blocking host-to-device copy per kernel call).  Returns the (n,) row
    ``contrib[i] + contrib - 2 G[i] M[i] - M @ G[i] - G @ M[i]``,
    unmasked — see :func:`.ref.swap_gain_ref`.
    """
    if not isinstance(i, torch.Tensor):
        i = torch.tensor([int(i)], dtype=torch.int64, device=M.device)
    i = i.reshape(1)
    if not use_kernel(impl, M):
        return swap_gain_ref(M[None], G, contrib[None], i)[0]
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"M must be (n, n), got {tuple(M.shape)}")
    n = M.shape[0]
    if G.shape != (n, n) or contrib.shape != (n,):
        raise ValueError(f"shapes G {tuple(G.shape)}, contrib "
                         f"{tuple(contrib.shape)} do not match M "
                         f"{tuple(M.shape)}")
    if M.dtype not in _FLOATS or G.dtype != M.dtype \
            or contrib.dtype != M.dtype:
        raise TypeError(f"M, G, contrib must share float32|float64, got "
                        f"{M.dtype}, {G.dtype}, {contrib.dtype}")
    if i.dtype != torch.int64:
        raise TypeError(f"mover i must be int64, got {i.dtype}")
    for t in (G, contrib, i):
        if t.device != M.device:
            raise ValueError(f"operand on {t.device}, M on {M.device}")
    for t in (M, G, contrib):
        if not t.is_contiguous():
            raise ValueError("swap_gain operands must be contiguous")
    lib = _lib()
    out = torch.empty(n, dtype=M.dtype, device=M.device)
    fn = lib.swap_gain_f64 if M.dtype == torch.float64 else lib.swap_gain_f32
    launch(lib, fn, "swap_gain", M.device, M.data_ptr(), G.data_ptr(),
           contrib.data_ptr(), i.data_ptr(), out.data_ptr(), n)
    count_launch("swap_gain", (n,))
    return out


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
    if M.dtype not in _FLOATS or G.dtype != M.dtype \
            or contrib.dtype != M.dtype:
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
    launch(lib, fn, "swap_select", M.device, M.data_ptr(), G.data_ptr(),
           contrib.data_ptr(), i.data_ptr(), n_valid.data_ptr(),
           part_v.data_ptr(), part_j.data_ptr(), gain.data_ptr(),
           j.data_ptr(), B, n)
    count_launch("swap_select", (B, n))
    return gain, j
