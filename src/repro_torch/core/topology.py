"""Topology graph H: torus platforms, routing R(u,v), fault-aware weights.

Implements the paper's platform model (Section 3):

* The platform is a d-dimensional torus (the paper evaluates 3D tori such as
  8x8x8; TPU v5e pods are 2D 16x16 tori — same machinery).
* Routing is dimension-ordered with shortest wrap-around direction per
  dimension, mirroring the fixed-routing assumption of the paper.  The
  routing function ``R(u, v)`` returns the ordered list of links traversed.
* Edge weights follow Eq. (1):

      w(e_uv) = sum_{l in R(u,v)}  c  +  c * 100 * 1[p_f(l_s) > 0 or p_f(l_d) > 0]

  i.e. a link costs ``c`` (one hop) when both endpoints are healthy and
  ``101 c`` when either endpoint has a non-zero outage probability, making
  any faulty path strictly more expensive than the longest healthy path.

Beyond the paper, :func:`TorusTopology.weight_matrix` accepts a *straggler*
vector: slow-but-alive nodes inflate link cost proportionally instead of the
hard 100x fault penalty (see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

import numpy as np

FAULT_PENALTY = 100.0  # the paper's "100" in Eq. (1)


@dataclasses.dataclass(frozen=True)
class Link:
    """A directed link between two adjacent torus nodes."""

    src: int
    dst: int


@dataclasses.dataclass(frozen=True)
class TorusTopology:
    """A d-dimensional torus with dimension-ordered shortest-path routing."""

    dims: tuple[int, ...]

    # ------------------------------------------------------------------ basics
    @property
    def n_nodes(self) -> int:
        return int(np.prod(self.dims))

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def coords(self, node: int) -> tuple[int, ...]:
        """Node id -> coordinates (row-major / x-major order)."""
        out = []
        for d in reversed(self.dims):
            out.append(node % d)
            node //= d
        return tuple(reversed(out))

    def coords_array(self) -> np.ndarray:
        """(n_nodes, ndim) coordinates for all nodes, row-major ids."""
        grids = np.meshgrid(*[np.arange(d) for d in self.dims], indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=1)

    def node_at(self, coords: Sequence[int]) -> int:
        node = 0
        for c, d in zip(coords, self.dims):
            node = node * d + (c % d)
        return int(node)

    # ----------------------------------------------------------------- routing
    def _dim_steps(self, a: int, b: int, dim: int) -> list[int]:
        """Shortest sequence of coordinates from a to b along one torus dim."""
        d = self.dims[dim]
        fwd = (b - a) % d
        bwd = (a - b) % d
        steps = []
        cur = a
        if fwd <= bwd:  # tie broken toward +1, as a fixed deterministic routing
            for _ in range(fwd):
                cur = (cur + 1) % d
                steps.append(cur)
        else:
            for _ in range(bwd):
                cur = (cur - 1) % d
                steps.append(cur)
        return steps

    def route(self, u: int, v: int) -> list[Link]:
        """R(u, v): ordered links of the dimension-ordered route u -> v."""
        if u == v:
            return []
        cu, cv = list(self.coords(u)), self.coords(v)
        links: list[Link] = []
        prev = u
        for dim in range(self.ndim):
            for step in self._dim_steps(cu[dim], cv[dim], dim):
                cu[dim] = step
                nxt = self.node_at(cu)
                links.append(Link(prev, nxt))
                prev = nxt
        return links

    def route_nodes(self, u: int, v: int) -> list[int]:
        """All nodes touched by R(u, v), endpoints included."""
        return [u] + [l.dst for l in self.route(u, v)]

    # --------------------------------------------------------------- distances
    def hop_matrix(self) -> np.ndarray:
        """(n, n) hop distances (sum over dims of shortest wrap distance).

        Memoised on first use: constructing a topology stays O(1), and
        repeat callers (engine cache misses across health states, scenario
        presets) share one dense matrix instead of recomputing the
        O(n^2 * ndim) derivation per call.
        """
        cached = self.__dict__.get("_hop_matrix")
        if cached is not None:
            return cached
        c = self.coords_array()  # (n, ndim)
        diff = np.abs(c[:, None, :] - c[None, :, :])  # (n, n, ndim)
        wrap = np.array(self.dims)[None, None, :] - diff
        out = np.minimum(diff, wrap).sum(axis=-1).astype(np.float64)
        # frozen dataclass: bypass __setattr__ for the memo slot
        object.__setattr__(self, "_hop_matrix", out)
        return out

    def lazy_distance(self, p_f: np.ndarray | None = None, c: float = 1.0,
                      straggler: np.ndarray | None = None):
        """O(n)-memory implicit view of :meth:`weight_matrix` — entries
        are computed from coordinates on indexing, bit-identical to the
        dense matrix (see :mod:`repro_torch.core.lazydist`)."""
        from .lazydist import TorusLazyDistance
        return TorusLazyDistance(self, p_f, c=c, straggler=straggler)

    def hierarchy_groups(self, target_groups: int = 64) -> np.ndarray:
        """(n,) contiguous-block group ids for hierarchical mapping.

        Splits the torus into >= ``target_groups`` axis-aligned bricks by
        repeatedly halving the dimension with the longest remaining
        segment — groups are compact sub-tori ("racks"), so the coarse
        mapper can treat group centroids as super-nodes.
        """
        segs = [1] * self.ndim
        n_groups = 1
        while n_groups < min(target_groups, self.n_nodes):
            k = max(range(self.ndim), key=lambda i: self.dims[i] / segs[i])
            if segs[k] >= self.dims[k]:
                break
            segs[k] *= 2
            n_groups = 1
            for s, d in zip(segs, self.dims):
                n_groups *= min(s, d)
        coords = self.coords_array()
        gid = np.zeros(self.n_nodes, dtype=np.int64)
        for i in range(self.ndim):
            s = min(segs[i], self.dims[i])
            gid = gid * s + (coords[:, i] * s) // self.dims[i]
        return gid

    def weight_matrix(
        self,
        p_f: np.ndarray | None = None,
        c: float = 1.0,
        straggler: np.ndarray | None = None,
    ) -> np.ndarray:
        """Pairwise path weights per Eq. (1) of the paper.

        ``p_f``        per-node outage probability (n,), or None == all healthy.
        ``straggler``  optional per-node slowdown factor >= 0 (beyond paper):
                       a link touching a straggler costs ``c * (1 + s)``.

        Returns an (n, n) matrix where entry (u, v) is the weight of the
        dimension-ordered route u -> v.  With no faults this equals
        ``c * hop_matrix()``.
        """
        n = self.n_nodes
        if p_f is None:
            p_f = np.zeros(n)
        p_f = np.asarray(p_f, dtype=np.float64)
        base = c * self.hop_matrix()
        faulty = p_f > 0
        slow = None
        if straggler is not None:
            slow = np.asarray(straggler, dtype=np.float64)
            if not np.any(slow > 0):
                slow = None
        if not faulty.any() and slow is None:
            return base

        # Count, per pair, the route links that touch a penalised node.  The
        # dimension-ordered route from u to v visits nodes u = n_0 .. n_k = v;
        # link i touches nodes (n_i, n_{i+1}).  A node x strictly inside the
        # route contributes to two links, an endpoint to one.
        w = base.copy()
        penal = np.flatnonzero(faulty)
        penal_set = set(int(x) for x in penal)
        slow_idx = set(np.flatnonzero(slow > 0).tolist()) if slow is not None else set()
        interesting = penal_set | slow_idx
        if not interesting:
            return w
        for u in range(n):
            for v in range(n):
                if u == v:
                    continue
                nodes = self.route_nodes(u, v)
                extra = 0.0
                for a, b in zip(nodes[:-1], nodes[1:]):
                    if a in penal_set or b in penal_set:
                        extra += c * FAULT_PENALTY
                    elif a in slow_idx or b in slow_idx:
                        sa = slow[a] if a in slow_idx else 0.0
                        sb = slow[b] if b in slow_idx else 0.0
                        extra += c * max(sa, sb)
                w[u, v] += extra
        return w

    def pairs_through(self, nodes) -> np.ndarray:
        """(n, n) bool: pairs whose dimension-ordered route touches any of
        ``nodes`` (endpoints included).

        While the route corrects dimension ``k``, the visited nodes have
        coordinates ``(v[<k], path(u[k] -> v[k]), u[>k])`` — so node x is
        on route(u, v) iff for some k the prefix of x matches v, the
        suffix matches u, and ``x[k]`` lies on the shortest wrap path in
        dimension k.  Vectorized over all pairs per probed node; used by
        :meth:`weight_matrix_update` to bound delta refreshes to exactly
        the entries a health change can invalidate.
        """
        c = self.coords_array()
        n = self.n_nodes
        aff = np.zeros((n, n), dtype=bool)
        for x in np.atleast_1d(np.asarray(nodes, dtype=np.int64)):
            xc = c[int(x)]
            # post[k]: u-side suffix match (u[j] == x[j] for all j > k-1);
            # post[k+1] is the constraint for dims strictly after k
            post = np.ones((self.ndim + 1, n), dtype=bool)
            for j in range(self.ndim - 1, -1, -1):
                post[j] = post[j + 1] & (c[:, j] == xc[j])
            pre = np.ones(n, dtype=bool)      # v-side prefix match (j < k)
            for k in range(self.ndim):
                d = self.dims[k]
                a = c[:, k]                   # u-side coordinate, dim k
                b = c[:, k]                   # v-side coordinate, dim k
                fwd = (b[None, :] - a[:, None]) % d
                bwd = (a[:, None] - b[None, :]) % d
                on_f = ((xc[k] - a[:, None]) % d) <= fwd
                on_b = ((a[:, None] - xc[k]) % d) <= bwd
                on = np.where(fwd <= bwd, on_f, on_b)
                aff |= post[k + 1][:, None] & pre[None, :] & on
                pre = pre & (c[:, k] == xc[k])
        np.fill_diagonal(aff, False)          # empty routes: nothing to touch
        return aff

    def weight_matrix_update(
        self,
        W_prev: np.ndarray,
        changed,
        p_f: np.ndarray | None = None,
        c: float = 1.0,
        straggler: np.ndarray | None = None,
    ) -> np.ndarray:
        """Row-wise delta refresh of :meth:`weight_matrix`.

        ``W_prev`` must be the weight matrix of a health state that
        differs from ``(p_f, straggler)`` exactly at the ``changed``
        node ids (penalty flag or slowdown value).  Only the entries
        whose routes touch a changed node are recomputed — with the same
        formula as the full derivation, so the result is bit-identical
        to ``weight_matrix(p_f, c, straggler)`` (asserted in
        ``tests/test_state.py``).
        """
        changed = np.atleast_1d(np.asarray(changed, dtype=np.int64))
        if changed.size == 0:
            return W_prev
        n = self.n_nodes
        p_f = np.zeros(n) if p_f is None else np.asarray(p_f, np.float64)
        base = c * self.hop_matrix()
        penal_set = set(np.flatnonzero(p_f > 0).tolist())
        slow = None
        if straggler is not None:
            slow = np.asarray(straggler, dtype=np.float64)
            if not np.any(slow > 0):
                slow = None
        slow_idx = (set(np.flatnonzero(slow > 0).tolist())
                    if slow is not None else set())
        aff = self.pairs_through(changed)
        W = W_prev.copy()
        for u, v in zip(*np.nonzero(aff)):
            nodes = self.route_nodes(int(u), int(v))
            extra = 0.0
            for a, b in zip(nodes[:-1], nodes[1:]):
                if a in penal_set or b in penal_set:
                    extra += c * FAULT_PENALTY
                elif a in slow_idx or b in slow_idx:
                    sa = slow[a] if a in slow_idx else 0.0
                    sb = slow[b] if b in slow_idx else 0.0
                    extra += c * max(sa, sb)
            W[u, v] = base[u, v] + extra
        return W

    # ------------------------------------------------------------- sub-extract
    def submatrix(self, weights: np.ndarray, nodes: Sequence[int]) -> np.ndarray:
        """ScotchExtract analogue: restrict a weight matrix to ``nodes``."""
        idx = np.asarray(nodes)
        return weights[np.ix_(idx, idx)]

    # ----------------------------------------------------------------- helpers
    def neighbors(self, node: int) -> list[int]:
        c = list(self.coords(node))
        out = []
        for dim in range(self.ndim):
            if self.dims[dim] == 1:
                continue
            for delta in (-1, +1):
                cc = list(c)
                cc[dim] = (cc[dim] + delta) % self.dims[dim]
                nb = self.node_at(cc)
                if nb != node:
                    out.append(nb)
        return sorted(set(out))

    def links(self) -> list[Link]:
        """All directed links of the torus."""
        out = []
        for u in range(self.n_nodes):
            for v in self.neighbors(u):
                out.append(Link(u, v))
        return out


def find_consecutive_healthy(
    p_f: np.ndarray, count: int, *, wrap: bool = False
) -> np.ndarray | None:
    """Step 10 of Listing 1.1: find ``count`` consecutive nodes with p_f == 0.

    "Consecutive" means consecutive node ids — the resource-manager ordering,
    exactly as in the paper (Slurm iterates nodes sequentially).  Returns the
    id array of the first such window, or None.  ``wrap=True`` also considers
    windows that wrap around the id space (torus ids are cyclic per row, the
    paper does not wrap; default off).
    """
    p_f = np.asarray(p_f)
    n = len(p_f)
    if count > n:
        return None
    healthy = (p_f == 0).astype(np.int64)
    if count == 0:
        return np.array([], dtype=np.int64)
    run = np.convolve(healthy, np.ones(count, dtype=np.int64), mode="valid")
    hits = np.flatnonzero(run == count)
    if hits.size:
        s = int(hits[0])
        return np.arange(s, s + count)
    if wrap:
        ext = np.concatenate([healthy, healthy[: count - 1]])
        run = np.convolve(ext, np.ones(count, dtype=np.int64), mode="valid")
        hits = np.flatnonzero(run == count)
        if hits.size:
            s = int(hits[0])
            return np.arange(s, s + count) % n
    return None


def arrangements(n_nodes: int, ndim: int = 3) -> list[tuple[int, ...]]:
    """All torus dim arrangements of ``n_nodes`` (Table 1 exploration)."""
    out = set()
    def rec(remaining: int, dims: tuple[int, ...]):
        if len(dims) == ndim - 1:
            out.add(dims + (remaining,))
            return
        for d in range(2, remaining + 1):
            if remaining % d == 0:
                rec(remaining // d, dims + (d,))
    rec(n_nodes, ())
    return sorted(out)
