"""hop_dist — implicit hop distances, computed from coordinates.

The implicit-distance contract of the mapping pipeline: instead of
gathering ``D[u, v]`` from a stored O(N^2) matrix, compute the metric
directly from the (N, ndim) coordinate table — O(N) memory for any
topology size.  Two metrics live here:

    torus:    hop(u, v) = sum_d min(|cu_d - cv_d|, dim_d - |cu_d - cv_d|)
    fat-tree: hop(u, v) = 0 | 2 | 4 | 6  (same host / edge / pod / across)

Three implementations share this module:

* :func:`torus_hop_np` / :func:`fattree_hop_np` (and their all-pairs
  forms) — pure NumPy, used by :class:`repro_torch.core.lazydist.LazyDistance`;
* :mod:`.ref` — plain PyTorch, the oracle of the kernels and the CPU path;
* ``hop_dist.cu`` — the CUDA kernels for Hopper (``sm_90a``).

``impl="auto"`` launches the CUDA kernel for tensors on a GPU and runs the
plain version for tensors on the CPU — chosen by the tensors' device and
nothing else.  ``impl="kernel"`` insists on the kernel (and raises for CPU
tensors); ``impl="ref"`` runs the plain version on any device.  A kernel
that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, count_launch, launch, use_kernel
from .ref import fattree_hop_pairs_ref, torus_hop_pairs_ref


# ------------------------------------------------------------------ numpy

def torus_hop_np(cu, cv, dims) -> np.ndarray:
    """Elementwise hop distance; broadcastable ``(..., ndim)`` coords in,
    float64 ``(...)`` out."""
    cu = np.asarray(cu, dtype=np.int64)
    cv = np.asarray(cv, dtype=np.int64)
    out = None
    for k, d in enumerate(dims):
        diff = np.abs(cu[..., k] - cv[..., k])
        h = np.minimum(diff, d - diff)
        out = h if out is None else out + h
    return np.asarray(out, dtype=np.float64)


def torus_hop_pairs_np(cu, cv, dims) -> np.ndarray:
    """All-pairs form: (m, ndim), (k, ndim) -> (m, k) float64."""
    cu = np.asarray(cu)
    cv = np.asarray(cv)
    return torus_hop_np(cu[:, None, :], cv[None, :, :], dims)


def fattree_hop_np(cu, cv) -> np.ndarray:
    """Elementwise fat-tree hop count from broadcastable (..., 3)
    (pod, edge, host) coordinate triples: 0 same host, 2 same edge
    switch, 4 same pod, 6 across pods."""
    cu = np.asarray(cu, dtype=np.int64)
    cv = np.asarray(cv, dtype=np.int64)
    same_pod = cu[..., 0] == cv[..., 0]
    same_edge = same_pod & (cu[..., 1] == cv[..., 1])
    same_host = same_edge & (cu[..., 2] == cv[..., 2])
    return 6.0 - 2.0 * same_pod - 2.0 * same_edge - 2.0 * same_host


def fattree_hop_pairs_np(cu, cv) -> np.ndarray:
    """All-pairs form: (m, 3), (k, 3) -> (m, k) float64."""
    cu = np.asarray(cu)
    cv = np.asarray(cv)
    return fattree_hop_np(cu[:, None, :], cv[None, :, :])


# ------------------------------------------------------------ torch dispatch

_P, _I64, _INT, _F64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_double)
_ARGTYPES = {"torus": [_P, _P, _P, _I64, _I64, _I64, _INT,
                       _F64, _F64, _F64, _F64, _P],
             "fattree": [_P, _P, _P, _I64, _I64, _I64, _P]}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# What every call would repeat, done once: the typed C entry point per
# (metric, dtype) and the torus launch arguments per dims tuple.  The
# implicit placement path calls these wrappers hundreds of times a
# placement at shapes where the launch itself takes microseconds, so the
# wrapper's host time is the larger cost there.
_FNS: dict = {}
_TORUS_ARGS: dict = {}


def _fn(kind: str, dtype: torch.dtype):
    fn = _FNS.get((kind, dtype))
    if fn is None:
        lib = _build.load("hop_dist")
        fn = getattr(lib, f"{kind}_hop_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES[kind]
        fn.restype = ctypes.c_int
        _FNS[(kind, dtype)] = fn
    return fn


def _torus_args(dims) -> tuple:
    """(nd, d0, d1, d2, d3) of the torus entry points for ``dims``."""
    key = dims if isinstance(dims, tuple) else tuple(dims)
    args = _TORUS_ARGS.get(key)
    if args is None:
        ints = tuple(int(d) for d in key)
        if not 1 <= len(ints) <= 4:
            raise ValueError(f"the torus kernel takes 1-4 dims, got {ints}")
        args = (len(ints), *(float(d) for d in ints),
                *(0.0,) * (4 - len(ints)))
        _TORUS_ARGS[key] = args
    return args


def _as_batched(cu: torch.Tensor, cv: torch.Tensor, width: int):
    """Validate kernel operands; returns (cu, cv) with a batch dim."""
    if cu.ndim != cv.ndim or cu.ndim not in (2, 3):
        raise ValueError(f"coords must both be (m, nd) or (B, m, nd), got "
                         f"{tuple(cu.shape)} and {tuple(cv.shape)}")
    if cu.ndim == 2:
        cu, cv = cu[None], cv[None]
    if cu.shape[0] != cv.shape[0] or cu.shape[2] != width \
            or cv.shape[2] != width:
        raise ValueError(f"coords {tuple(cu.shape)} / {tuple(cv.shape)} do "
                         f"not match batch and width {width}")
    if cu.device != cv.device:
        raise ValueError(f"coords on {cu.device} and {cv.device}")
    if cu.dtype != cv.dtype or cu.dtype not in _SUFFIX:
        raise TypeError(f"coords must share float32|float64, got "
                        f"{cu.dtype} and {cv.dtype}")
    if not (cu.is_contiguous() and cv.is_contiguous()):
        raise ValueError("coords must be contiguous")
    return cu, cv


def _launch(kind: str, name: str, cu: torch.Tensor, cv: torch.Tensor,
            width: int, *extra) -> torch.Tensor:
    """Validate, allocate the (B, m, k) output, launch, count the launch."""
    cu3, cv3 = _as_batched(cu, cv, width)
    B, m, k = cu3.shape[0], cu3.shape[1], cv3.shape[1]
    out = torch.empty((B, m, k), dtype=cu3.dtype, device=cu3.device)
    launch(_build.load("hop_dist"), _fn(kind, cu3.dtype), name, cu3.device,
           cu3.data_ptr(), cv3.data_ptr(), out.data_ptr(), B, m, k, *extra)
    count_launch(name, (B, m, k))
    return out if cu.ndim == 3 else out[0]


def torus_hop(cu: torch.Tensor, cv: torch.Tensor, dims, *,
              impl: str = "auto") -> torch.Tensor:
    """All-pairs torus hops: (B, m, nd), (B, k, nd) -> (B, m, k), or the
    unbatched (m, nd), (k, nd) -> (m, k).  Output dtype follows the
    coordinates (float32 or float64 holding exact small integers)."""
    if not use_kernel(impl, cu):
        return torus_hop_pairs_ref(cu, cv, tuple(int(d) for d in dims))
    args = _torus_args(dims)
    return _launch("torus", "torus_hop", cu, cv, args[0], *args)


def fattree_hop(cu: torch.Tensor, cv: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """All-pairs fat-tree hops from (pod, edge, host) coords:
    (B, m, 3), (B, k, 3) -> (B, m, k), or unbatched (m, 3), (k, 3) ->
    (m, k).  The caller applies ``scale * hops + penalty`` in torch."""
    if not use_kernel(impl, cu):
        return fattree_hop_pairs_ref(cu, cv)
    return _launch("fattree", "fattree_hop", cu, cv, 3)
