"""LazyDistance — numpy-indexable implicit distance matrices, O(N) memory.

Above the engine's size threshold, :meth:`TorusTopology.lazy_distance` /
:meth:`FatTreeTopology.lazy_distance` hand the mapping pipeline one of
these adapters instead of a dense (N, N) matrix.  Every indexing idiom
the hot kernels use —

    D[i]                     row            (N,)
    D[rows]                  row block      (len(rows), N)
    D[i, j] / D[i, cols]     elementwise
    D[np.ix_(rows, cols)]    open-mesh block
    D[P[:, :, None], P[:, None, :]]   broadcast fancy (hop_bytes_batch)

— is computed on demand from the coordinate table in O(#requested
elements) memory, bit-identical to the entries the topology's dense
``weight_matrix`` would hold (differentially asserted in
``tests/test_multilevel.py``).  ``np.asarray(D)`` raises: nothing in the
pipeline may silently densify the matrix.

Fault/straggler weighting stays **exact**, not approximate.  For the
torus, the Eq. (1) extra terms are nonzero only for pairs whose
dimension-ordered route touches a penalised node; the adapter flags
candidate pairs with the same vectorized route-membership conditions as
:meth:`TorusTopology.pairs_through` and walks the route scalar-exactly
for flagged pairs only — O(f * n^(1/ndim)) work per requested row for f
penalised nodes, instead of O(n^2 * hops) for the dense derivation.
Fat-tree weighting is endpoint-form and trivially elementwise.

The healthy uniform-cost torus case — and the fat-tree in *every*
health state, its weighting being endpoint-form — additionally exposes
an ``implicit`` spec (coordinates + metric kind + scale + optional
penalty vector) that lets the torch backend compute distances in-kernel
(:mod:`repro_torch.kernels.hop_dist`) instead of going through
``__getitem__`` at all.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.kernels.hop_dist.ops import torus_hop_np


@dataclasses.dataclass(frozen=True)
class ImplicitSpec:
    """What the torch backend needs to compute distances in-kernel:
    per-node integer coordinates, a static metric spec, a uniform scale.

    ``kind="torus"`` interprets ``coords`` against wraparound ``dims``;
    ``kind="fattree"`` interprets them as (pod, edge, host) triples with
    ``dims=()`` and carries the per-node endpoint ``penalty`` vector
    (zeros when healthy — always present so the backend's identity-keyed
    device-transfer cache has a stable array to pin).
    """

    coords: np.ndarray          # (N, ndim) float64 — stable identity for
                                # the backend's device-transfer cache
    dims: tuple[int, ...]
    scale: float
    kind: str = "torus"
    penalty: Optional[np.ndarray] = None    # (N,) float64, fat-tree only


class LazyDistance:
    """Base adapter: numpy-compatible read-only 2-D indexing over an
    implicit distance function."""

    ndim = 2
    dtype = np.dtype(np.float64)

    def __init__(self, n: int):
        self.shape = (n, n)

    # ---- subclass hook -------------------------------------------------
    def _elems(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Entries D[u, v] for same-shape int arrays ``u``, ``v``."""
        raise NotImplementedError

    # ---- numpy protocol ------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        raise TypeError(
            f"refusing to densify a {type(self).__name__} of shape "
            f"{self.shape} — index it (rows / pairs / np.ix_ blocks) "
            f"instead, or use the topology's dense weight_matrix() below "
            f"the lazy threshold")

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def implicit(self) -> Optional[ImplicitSpec]:
        """In-kernel computation spec, or None when only ``__getitem__``
        applies (faults, stragglers, non-torus)."""
        return None

    def _axis(self, key, n: int) -> np.ndarray:
        if isinstance(key, slice):
            return np.arange(*key.indices(n))
        a = np.asarray(key)
        if a.dtype == bool:
            a = np.flatnonzero(a)
        return a.astype(np.int64, copy=False)

    def __getitem__(self, key):
        n = self.shape[0]
        if isinstance(key, tuple):
            if len(key) != 2:
                raise IndexError(
                    f"{type(self).__name__} supports 2-d indexing only")
            u, v = (self._axis(key[0], n), self._axis(key[1], n))
            both_scalar = u.ndim == 0 and v.ndim == 0
            u, v = np.broadcast_arrays(u, v)
            out = self._elems(u, v)
            return float(out) if both_scalar else out
        rows = self._axis(key, n)
        cols = np.arange(n, dtype=np.int64)
        u, v = np.broadcast_arrays(rows[..., None], cols)
        return self._elems(u, v)


class TorusLazyDistance(LazyDistance):
    """Implicit Eq. (1) route weights of a :class:`TorusTopology`."""

    def __init__(self, topo, p_f: Optional[np.ndarray] = None,
                 c: float = 1.0, straggler: Optional[np.ndarray] = None):
        super().__init__(topo.n_nodes)
        self.topo = topo
        self.c = float(c)
        self.coords = topo.coords_array().astype(np.int64)
        self.dims = tuple(topo.dims)
        penal = (np.zeros(topo.n_nodes, dtype=bool) if p_f is None
                 else np.asarray(p_f, np.float64) > 0)
        slow = None
        if straggler is not None:
            s = np.asarray(straggler, dtype=np.float64)
            if (s > 0).any():
                slow = s
        self._penal = penal
        self._slow = slow
        slow_mask = np.zeros(topo.n_nodes, bool) if slow is None else slow > 0
        self._interesting = np.flatnonzero(penal | slow_mask)
        self._pair_cache: dict[tuple[int, int], float] = {}
        self._spec = None
        if self._interesting.size == 0:
            self._spec = ImplicitSpec(
                coords=self.coords.astype(np.float64),
                dims=self.dims, scale=self.c)

    @property
    def implicit(self) -> Optional[ImplicitSpec]:
        return self._spec

    def _elems(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        cu = self.coords[u]
        cv = self.coords[v]
        out = self.c * torus_hop_np(cu, cv, self.dims)
        if self._interesting.size == 0:
            return out
        flagged = self._on_route_any(u, v, cu, cv)
        if not flagged.any():
            return out
        out = np.ascontiguousarray(out)
        flat = np.flatnonzero(flagged.ravel())
        uu = u.ravel()[flat]
        vv = v.ravel()[flat]
        extra = np.fromiter(
            (self._route_extra(int(a), int(b)) for a, b in zip(uu, vv)),
            dtype=np.float64, count=flat.size)
        out.ravel()[flat] += extra
        return out

    def _on_route_any(self, u, v, cu, cv) -> np.ndarray:
        """Pairs whose dimension-ordered route u -> v touches any
        penalised/straggling node — the elementwise form of
        :meth:`TorusTopology.pairs_through` (same membership conditions,
        evaluated per requested pair instead of over the full (n, n))."""
        ndim = len(self.dims)
        aff = np.zeros(u.shape, dtype=bool)
        for x in self._interesting:
            xc = self.coords[int(x)]
            # u-side suffix match for dims strictly after k
            post = np.ones(u.shape + (ndim + 1,), dtype=bool)
            for j in range(ndim - 1, -1, -1):
                post[..., j] = post[..., j + 1] & (cu[..., j] == xc[j])
            pre = np.ones(u.shape, dtype=bool)   # v-side prefix match
            for k in range(ndim):
                d = self.dims[k]
                a = cu[..., k]
                b = cv[..., k]
                fwd = (b - a) % d
                bwd = (a - b) % d
                on_f = ((xc[k] - a) % d) <= fwd
                on_b = ((a - xc[k]) % d) <= bwd
                on = np.where(fwd <= bwd, on_f, on_b)
                aff |= post[..., k + 1] & pre & on
                pre = pre & (cv[..., k] == xc[k])
        return aff & (u != v)                    # empty routes touch nothing

    def _route_extra(self, u: int, v: int) -> float:
        """Exact Eq. (1) extra for one pair: the same scalar route walk as
        :meth:`TorusTopology.weight_matrix` (memoised — refinement re-reads
        the same flagged pairs many times)."""
        hit = self._pair_cache.get((u, v))
        if hit is not None:
            return hit
        penal = self._penal
        slow = self._slow
        c = self.c
        from .topology import FAULT_PENALTY
        nodes = self.topo.route_nodes(u, v)
        extra = 0.0
        for a, b in zip(nodes[:-1], nodes[1:]):
            if penal[a] or penal[b]:
                extra += c * FAULT_PENALTY
            elif slow is not None and (slow[a] > 0 or slow[b] > 0):
                extra += c * max(slow[a], slow[b])
        if len(self._pair_cache) > 2_000_000:    # bound the memo
            self._pair_cache.clear()
        self._pair_cache[(u, v)] = extra
        return extra


class FatTreeLazyDistance(LazyDistance):
    """Implicit endpoint-form Eq. (1) weights of a
    :class:`FatTreeTopology` (exact for any health state — paths touch
    compute nodes only at their endpoints).

    Because the fault/straggler weighting is a per-endpoint penalty
    gather — no route walks — the adapter exposes an ``implicit`` spec
    for **every** health state, so the torch backend compiles fat-tree
    distances in-kernel even under faults (tori only qualify healthy).
    """

    def __init__(self, topo, p_f: Optional[np.ndarray] = None,
                 c: float = 1.0, straggler: Optional[np.ndarray] = None):
        super().__init__(topo.n_nodes)
        self.topo = topo
        self.c = float(c)
        self.coords = topo.coords_array().astype(np.int64)
        from .topology import FAULT_PENALTY
        penalty = np.zeros(topo.n_nodes)
        if p_f is not None:
            penalty += c * FAULT_PENALTY * (np.asarray(p_f, np.float64) > 0)
        if straggler is not None:
            penalty += c * np.asarray(straggler, dtype=np.float64)
        self._penalty = penalty if (penalty > 0).any() else None
        # the zeros vector is kept (not None) so the spec always carries
        # a stable array for the backend's identity-keyed transfer cache
        self._spec = ImplicitSpec(
            coords=self.coords.astype(np.float64), dims=(), scale=self.c,
            kind="fattree", penalty=penalty)

    @property
    def implicit(self) -> Optional[ImplicitSpec]:
        return self._spec

    def _elems(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        from repro_torch.kernels.hop_dist.ops import fattree_hop_np
        out = self.c * fattree_hop_np(self.coords[u], self.coords[v])
        if self._penalty is not None:
            out += np.where(u != v, self._penalty[u] + self._penalty[v], 0.0)
        return out


def is_lazy(D) -> bool:
    """True when ``D`` is a lazy adapter rather than a dense ndarray."""
    return isinstance(D, LazyDistance)
