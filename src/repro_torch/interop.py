"""Carry placement inputs across from the reference's plain arrays.

The reference package (``repro``) and this port each have their own
``CommGraph``, ``ClusterState``, topologies and ``PlacementRequest``
classes; the port imports nothing of ``repro``.  What the two share is
data: guest matrices, torus extents or fat-tree arity, outage beliefs,
straggler factors and lifecycle codes, all plain NumPy arrays or ints.
These functions build the port's objects from that data, so a test can
place the same job with both packages and compare the results.  There
are no weights to load: the system has none.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .core.comm_graph import CommGraph
from .core.engine import PlacementRequest
from .core.fattree import FatTreeTopology
from .core.state import ClusterState
from .core.topology import TorusTopology


def comm_graph(G_v: np.ndarray, G_m: Optional[np.ndarray] = None
               ) -> CommGraph:
    """The guest graph from its (n, n) byte and message matrices."""
    G_v = np.array(G_v, dtype=np.float64)
    n = G_v.shape[0]
    G_m = (np.zeros((n, n)) if G_m is None
           else np.array(G_m, dtype=np.float64))
    return CommGraph(n, G_v=G_v, G_m=G_m)


def topology(*, torus_dims: Optional[Sequence[int]] = None,
             fattree_k: Optional[int] = None):
    """A torus from its extents, or a k-ary fat tree from its arity."""
    if (torus_dims is None) == (fattree_k is None):
        raise ValueError("give exactly one of torus_dims, fattree_k")
    if torus_dims is not None:
        return TorusTopology(tuple(int(d) for d in torus_dims))
    return FatTreeTopology(int(fattree_k))


def cluster_state(health: np.ndarray, p_f: Optional[np.ndarray] = None
                  ) -> ClusterState:
    """A health snapshot from per-node lifecycle codes (the reference's
    ``ClusterState.health``: 0 UP, 1 DEGRADED, 2 DRAINED, 3 DOWN) and
    outage beliefs.  Each call mints a new epoch unless the arrays
    describe the all-healthy state; reuse the returned object to keep
    the engine's epoch-keyed caches warm."""
    health = np.asarray(health, dtype=np.int8)
    n = len(health)
    p = np.zeros(n) if p_f is None else np.asarray(p_f, dtype=np.float64)
    return ClusterState.healthy(n).evolve(health=health, p_f=p)


def request(G_v: np.ndarray, G_m: Optional[np.ndarray] = None, *,
            torus_dims: Optional[Sequence[int]] = None,
            fattree_k: Optional[int] = None,
            state: Optional[ClusterState] = None,
            p_f: Optional[np.ndarray] = None,
            available: Optional[np.ndarray] = None,
            straggler: Optional[np.ndarray] = None,
            metric: str = "volume", seed: int = 0) -> PlacementRequest:
    """A placement request from the reference's arrays.

    Health travels either as a port ``state`` (see :func:`cluster_state`)
    or as the legacy ``(p_f, available)`` arrays, exactly as the
    reference's ``PlacementRequest`` takes them — the legacy path interns
    by content, so equal arrays give one epoch in both packages.
    """
    return PlacementRequest(
        comm=comm_graph(G_v, G_m),
        topology=topology(torus_dims=torus_dims, fattree_k=fattree_k),
        state=state, p_f=p_f, available=available, straggler=straggler,
        metric=metric, seed=seed)
