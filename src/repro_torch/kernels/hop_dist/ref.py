"""Implicit hop distances — plain PyTorch versions.

The oracle of the CUDA kernels in ``hop_dist.cu`` and the CPU path of
:mod:`repro_torch.kernels.hop_dist.ops`.  The per-dimension loop is
unrolled in Python (``dims`` is a short tuple), so no (..., ndim)
intermediate beyond the broadcast inputs is materialised.  Outputs take
the dtype of the coordinate tensors.
"""
from __future__ import annotations

import torch


def torus_hop_elems_ref(cu: torch.Tensor, cv: torch.Tensor, dims):
    """Broadcast-elementwise hop distance: ``(..., ndim)`` coords in,
    ``(...)`` out."""
    out = None
    for k, d in enumerate(dims):
        diff = (cu[..., k] - cv[..., k]).abs()
        h = torch.minimum(diff, d - diff)
        out = h if out is None else out + h
    return out


def torus_hop_pairs_ref(cu: torch.Tensor, cv: torch.Tensor, dims):
    """All-pairs form: (..., m, ndim), (..., k, ndim) -> (..., m, k)."""
    return torus_hop_elems_ref(cu[..., :, None, :], cv[..., None, :, :], dims)


def fattree_hop_elems_ref(cu: torch.Tensor, cv: torch.Tensor):
    """Broadcast-elementwise fat-tree hop count from (pod, edge, host)
    coordinate triples: 0 same host, 2 same edge switch, 4 same pod,
    6 across pods.  Branchless — each matching level subtracts 2 hops and
    the masks nest — so values are the exact small integers of the NumPy
    version, in the coordinates' dtype."""
    dt = cu.dtype
    same_pod = cu[..., 0] == cv[..., 0]
    same_edge = same_pod & (cu[..., 1] == cv[..., 1])
    same_host = same_edge & (cu[..., 2] == cv[..., 2])
    return (6.0 - 2.0 * same_pod.to(dt) - 2.0 * same_edge.to(dt)
            - 2.0 * same_host.to(dt))


def fattree_hop_pairs_ref(cu: torch.Tensor, cv: torch.Tensor):
    """All-pairs form: (..., m, 3), (..., k, 3) -> (..., m, k)."""
    return fattree_hop_elems_ref(cu[..., :, None, :], cv[..., None, :, :])
