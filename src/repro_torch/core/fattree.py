"""Fat-tree host topology — the Clos-network counterpart of the torus.

A k-ary fat tree (Al-Fares et al., SIGCOMM 2008) has ``k`` pods, each with
``k/2`` edge switches serving ``k/2`` hosts, for ``k^3/4`` hosts total.
Compute nodes are the hosts; switches appear only in the distance model:

    same host                     0 hops
    same edge switch              2 hops   (host - edge - host)
    same pod, different edge      4 hops   (host - edge - agg - edge - host)
    different pods                6 hops   (... - core - ...)

Host ids are ordered (pod, edge, host), so *consecutive ids are maximally
co-located* — exactly the property TOFA's consecutive-healthy-window search
(Listing 1.1, step 10) and the resource-manager ordering assume.  Fault
weighting follows Eq. (1) in endpoint form: hosts do not relay traffic in a
Clos fabric, so only the first/last link of a path can touch a faulty
compute node.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import FAULT_PENALTY


@dataclasses.dataclass(frozen=True)
class FatTreeTopology:
    """k-ary fat tree of ``k**3 // 4`` hosts (k even, >= 2)."""

    k: int = 4

    def __post_init__(self):
        if self.k < 2 or self.k % 2:
            raise ValueError(f"fat-tree arity k must be even and >= 2, got {self.k}")

    # ------------------------------------------------------------------ basics
    @property
    def hosts_per_edge(self) -> int:
        return self.k // 2

    @property
    def edges_per_pod(self) -> int:
        return self.k // 2

    @property
    def hosts_per_pod(self) -> int:
        return self.hosts_per_edge * self.edges_per_pod

    @property
    def n_nodes(self) -> int:
        return self.hosts_per_pod * self.k

    def coords(self, node: int) -> tuple[int, int, int]:
        """Host id -> (pod, edge switch, host slot)."""
        pod, rest = divmod(node, self.hosts_per_pod)
        edge, host = divmod(rest, self.hosts_per_edge)
        return (pod, edge, host)

    def coords_array(self) -> np.ndarray:
        """(n_nodes, 3) (pod, edge, host) coordinates, id-ordered."""
        ids = np.arange(self.n_nodes)
        pod, rest = np.divmod(ids, self.hosts_per_pod)
        edge, host = np.divmod(rest, self.hosts_per_edge)
        return np.stack([pod, edge, host], axis=1)

    # --------------------------------------------------------------- distances
    def hop_matrix(self) -> np.ndarray:
        """(n, n) switch-level hop distances (0 / 2 / 4 / 6).

        Memoised on first use so topology construction stays O(1) and
        repeat callers share one dense matrix.
        """
        cached = self.__dict__.get("_hop_matrix")
        if cached is not None:
            return cached
        c = self.coords_array()
        same_pod = c[:, None, 0] == c[None, :, 0]
        same_edge = same_pod & (c[:, None, 1] == c[None, :, 1])
        same_host = same_edge & (c[:, None, 2] == c[None, :, 2])
        hops = np.full((self.n_nodes, self.n_nodes), 6.0)
        hops[same_pod] = 4.0
        hops[same_edge] = 2.0
        hops[same_host] = 0.0
        object.__setattr__(self, "_hop_matrix", hops)
        return hops

    def lazy_distance(self, p_f: np.ndarray | None = None, c: float = 1.0,
                      straggler: np.ndarray | None = None):
        """O(n)-memory implicit view of :meth:`weight_matrix` — exact for
        any health state (endpoint-form weighting)."""
        from .lazydist import FatTreeLazyDistance
        return FatTreeLazyDistance(self, p_f, c=c, straggler=straggler)

    def hierarchy_groups(self, target_groups: int = 64) -> np.ndarray:
        """(n,) group ids for hierarchical mapping: one group per edge
        switch (the natural "rack" of a fat-tree — hosts under one edge
        are mutually 2 hops)."""
        c = self.coords_array()
        return (c[:, 0] * self.edges_per_pod + c[:, 1]).astype(np.int64)

    def weight_matrix(
        self,
        p_f: np.ndarray | None = None,
        c: float = 1.0,
        straggler: np.ndarray | None = None,
    ) -> np.ndarray:
        """Eq. (1) path weights in endpoint form.

        A path's only compute-node contacts are its two endpoints, so the
        weight is ``c * hops`` plus ``c * 100`` per faulty endpoint and
        ``c * s`` per straggling endpoint (slowdown factor ``s``).
        """
        n = self.n_nodes
        w = c * self.hop_matrix()
        penalty = np.zeros(n)
        if p_f is not None:
            penalty += c * FAULT_PENALTY * (np.asarray(p_f, dtype=np.float64) > 0)
        if straggler is not None:
            penalty += c * np.asarray(straggler, dtype=np.float64)
        if (penalty > 0).any():
            extra = penalty[:, None] + penalty[None, :]
            np.fill_diagonal(extra, 0.0)
            w = w + extra
        return w

    def weight_matrix_update(
        self,
        W_prev: np.ndarray,
        changed,
        p_f: np.ndarray | None = None,
        c: float = 1.0,
        straggler: np.ndarray | None = None,
    ) -> np.ndarray:
        """Row-wise delta refresh of :meth:`weight_matrix`.

        In endpoint form a node's health only enters through its own
        penalty term, so a change at node x invalidates exactly row x and
        column x.  Recomputed entries use the same expression as the full
        derivation (bit-identical; see ``tests/test_state.py``).
        """
        changed = np.atleast_1d(np.asarray(changed, dtype=np.int64))
        if changed.size == 0:
            return W_prev
        n = self.n_nodes
        penalty = np.zeros(n)
        if p_f is not None:
            penalty += c * FAULT_PENALTY * (np.asarray(p_f, np.float64) > 0)
        if straggler is not None:
            penalty += c * np.asarray(straggler, dtype=np.float64)
        extra = penalty[:, None] + penalty[None, :]
        np.fill_diagonal(extra, 0.0)
        base = c * self.hop_matrix()
        ref = base + extra
        W = W_prev.copy()
        W[changed, :] = ref[changed, :]
        W[:, changed] = ref[:, changed]
        return W
