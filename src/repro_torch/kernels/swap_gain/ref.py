"""Swap-gain oracle — the dense gains row of the pairwise-swap refiner.

For mover ``i`` over a placement with gathered pairwise distances ``M``
and guest weights ``G`` (``contrib = (G * M).sum(1)``), the gain of
swapping ``i`` with every other process ``j`` is

    gains = contrib[i] + contrib - 2 * G[i] * M[i] - M @ G[i] - G @ M[i]

(the i<->j mutual term cancels because swapping endpoints preserves
their own distance).  Everything here is batched over a leading
candidate dimension ``B``: ``M`` (B, n, n) per candidate, ``G`` (n, n)
shared, ``contrib`` (B, n), movers ``i`` (B,).  This plain PyTorch
version is the oracle of the CUDA kernel in ``swap_select.cu`` and the
CPU path of :mod:`repro_torch.kernels.swap_gain.ops`.
"""
from __future__ import annotations

import torch

# swap acceptance threshold — shared with the refine loops
# (repro_torch.core.mapping._pairwise_refine and mapping_torch._refine)
GAIN_EPS = 1e-9


def swap_gain_ref(M, G, contrib, i):
    """(B, n, n), (n, n), (B, n), (B,) movers -> (B, n) gains rows."""
    ar = torch.arange(M.shape[0], device=M.device)
    Mi, Gi = M[ar, i], G[i]
    a = torch.bmm(M, Gi.unsqueeze(-1)).squeeze(-1)          # M @ G[i]
    b = Mi @ G.T                                            # G @ M[i]
    return contrib[ar, i].unsqueeze(-1) + contrib - 2.0 * Gi * Mi - a - b


def swap_select_ref(M, G, contrib, i, n_valid):
    """Fused select step of the refiner: gains row + masked argmax +
    the apply decision.

    Returns ``(gain, j)`` per candidate: the best masked gain and the
    swap partner.  Masking matches the refine loop exactly — ``gains[i]
    = 0`` (the identity swap), columns ``>= n_valid`` are ``-inf``
    padding — and the argmax keeps the *first* occurrence on ties.  When
    the best gain does not clear ``GAIN_EPS`` (compared in the compute
    dtype) or mover ``i`` is itself padding, ``j == i`` so the caller
    applies the returned swap unconditionally.
    """
    g = swap_gain_ref(M, G, contrib, i)
    B, n = g.shape
    ar = torch.arange(B, device=g.device)
    g[ar, i] = 0.0
    g = torch.where(torch.arange(n, device=g.device) < n_valid, g,
                    float("-inf"))
    j_raw = g.argmax(dim=1)
    gain = g[ar, j_raw]
    j = torch.where((gain > GAIN_EPS) & (i < n_valid), j_raw, i)
    return gain, j
