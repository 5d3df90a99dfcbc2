"""Torch implementations of the mapping hot kernels (the device backend).

Only reached when the ``torch`` backend is active
(:mod:`repro_torch.core.backend`).  Every public function mirrors its
:mod:`repro_torch.core.mapping` counterpart — NumPy arrays in, NumPy
arrays out — and is **decision-identical** to it: with the in-tree
workloads all guest weights and route distances are exactly-representable
integers, float64 arithmetic on them is exact, and the expressions below
are algebraic rearrangements of the NumPy ones, so at ``dtype="float64"``
the same swaps are accepted in the same order and the returned
placements match the NumPy backend bit-for-bit.

What the port changes is the cost model, not the algorithm:

* **All candidates refine in one batched loop.**  ``refine_many`` carries
  an explicit leading candidate dimension ``B`` through every tensor
  (TOFA's windows, balls and snake seeds), indexing per-candidate movers
  as ``M[arange(B), i]`` — no Python loop over candidates.  A candidate
  whose pass accepted no swap stops: its later movers are masked to
  identity swaps, exactly as the reference's batched ``while_loop`` keeps
  a converged lane's state.  The host reads the device once per pass
  (did any lane improve?), never per mover.
* **Swap-gain scoring is gather+matvec, not dense matvec.**  Sparse
  guests (NPB-DT at n=1024 has ~3 edges per rank) evaluate the per-mover
  gains row from CSR-padded rows of ``G`` in O(n*k); products against
  explicit zeros contribute exactly 0.0, so this is bit-equal to the
  dense evaluation.  Guests denser than half-full take the dense branch,
  whose select step is the ``swap_select`` CUDA kernel.
* **Distances may be implicit.**  A lazy metric with an ``implicit`` spec
  (healthy torus, fat-tree in any health state) never materialises an
  (N, N) matrix: the all-pairs start matrix of each candidate comes from
  the ``torus_hop`` / ``fattree_hop`` CUDA kernels and the per-mover rows
  from their elementwise plain versions.
* **Distance matrices are device-resident.**  Hosts hand the same cached
  (topology, health) matrix object to every placement, and the backend
  keeps its symmetrised device copy alive across jobs.
"""
from __future__ import annotations

import functools
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..kernels.hop_dist import ops as hop_ops
from ..kernels.hop_dist.ref import fattree_hop_elems_ref, torus_hop_elems_ref
from ..kernels.swap_gain.ops import swap_select
from ..kernels.swap_gain.ref import GAIN_EPS
from . import backend as _backend

_INF = float("inf")

# calls and wall seconds per device entry point since the last
# :func:`reset_stats`.  Each entry point ends in a device-to-host copy, so
# its wall time covers its device work.
STATS = {name: {"calls": 0, "s": 0.0} for name in (
    "refine_many", "hop_bytes_batch", "select_nodes", "greedy_placement")}


def reset_stats() -> None:
    for rec in STATS.values():
        rec["calls"], rec["s"] = 0, 0.0


def _timed(fn):
    rec = STATS[fn.__name__]

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            rec["calls"] += 1
            rec["s"] += time.perf_counter() - t0
    return run


# --------------------------------------------------------------------------
# host-side preparation (sparse structure, symmetrised distances, padding)
# --------------------------------------------------------------------------

def _pow2(x: int) -> int:
    return 1 << max(0, int(x - 1)).bit_length() if x > 1 else 1


class _IdLRU:
    """Tiny identity-keyed LRU holding host intermediates alive."""

    def __init__(self, maxlen: int = 8):
        self._d: OrderedDict[int, tuple] = OrderedDict()
        self._maxlen = maxlen

    def get(self, key_obj, fn):
        key = id(key_obj)
        hit = self._d.get(key)
        if hit is not None and hit[0] is key_obj:
            self._d.move_to_end(key)
            return hit[1]
        out = fn()
        self._d[key] = (key_obj, out)   # strong ref pins id()
        while len(self._d) > self._maxlen:
            self._d.popitem(last=False)
        return out


_SPARSE_CACHE = _IdLRU()
_SYM_CACHE = _IdLRU()
_GUEST_OK_CACHE = _IdLRU(maxlen=32)
_SPARSE_DEV_CACHE = _IdLRU()


def guest_supported(G_w: np.ndarray) -> bool:
    """The device kernels assume the symmetric-guest convention
    (CommGraph accumulates both directions); asymmetric guests run the
    NumPy kernels at the dispatch layer.  Cached by identity."""
    return _GUEST_OK_CACHE.get(
        G_w, lambda: bool(np.array_equal(G_w, G_w.T)))


def lazy_supported(D) -> bool:
    """A lazy distance adapter is served here only when it exposes an
    implicit spec — distances are then computed from coordinates, never
    gathered from a stored matrix.  Healthy uniform tori and fat-trees in
    *any* health state qualify; fault-weighted tori need scalar route
    walks and run the NumPy kernels instead."""
    return getattr(D, "implicit", None) is not None


def _sparse_rows(G_w: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """CSR-padded rows of the (diag-zeroed) guest: (idx, val, k_pad, G).

    Rows are padded to a multiple-of-4 width with (index 0, weight 0.0)
    entries — gathers against them multiply by exactly 0.0, so padding
    never changes a result.
    """
    def build():
        G = np.asarray(G_w, dtype=np.float64)
        if np.count_nonzero(np.diagonal(G)):
            G = G.copy()
            np.fill_diagonal(G, 0.0)
        n = G.shape[0]
        nnz = (G != 0.0).sum(axis=1)
        k_true = max(1, int(nnz.max()) if n else 1)
        k = min(_pow2(n), (k_true + 3) & ~3)
        idx = np.zeros((n, k), dtype=np.int64)
        val = np.zeros((n, k), dtype=np.float64)
        for r in range(n):
            cols = np.flatnonzero(G[r])
            idx[r, :len(cols)] = cols
            val[r, :len(cols)] = G[r, cols]
        return idx, val, k, G
    return _SPARSE_CACHE.get(G_w, build)


def _sym_host(D: np.ndarray) -> np.ndarray:
    """0.5*(D + D.T), cached by identity — the symmetrised route-weight
    view every gathered-distance expression in the NumPy kernel uses."""
    return _SYM_CACHE.get(
        D, lambda: 0.5 * (np.asarray(D, np.float64)
                          + np.asarray(D, np.float64).T))


def _be():
    be = _backend.active()
    if not getattr(be, "is_torch", False):   # direct calls outside dispatch
        be = _backend.get_backend("torch")
    return be


def _pad_placements(placements: np.ndarray) -> tuple[np.ndarray, int, int]:
    """(B, n) -> zero-padded (B, n_pad) int64 plus original n."""
    P = np.asarray(placements, dtype=np.int64)
    B, n = P.shape
    n_pad = _pow2(n)
    if n_pad != n:
        P = np.pad(P, ((0, 0), (0, n_pad - n)))
    return P, n, n_pad


def _guest_device(G_w: np.ndarray, n_pad: int, be, device=None):
    """Device-resident guest structure (idx, val, G_dense) on ``device``
    (by default the backend's), cached by guest identity so repeated
    refine/score calls against one job's graph pay a single transfer.
    ``G_dense`` is None on the sparse branch."""
    dev = be.device if device is None else device
    def build():
        idx, val, k, G = _sparse_rows(G_w)
        n = idx.shape[0]
        if n_pad != n:
            idx = np.pad(idx, ((0, n_pad - n), (0, 0)))
            val = np.pad(val, ((0, n_pad - n), (0, 0)))
        G_dense = None
        if k > max(8, n_pad // 2):                     # the dense branch
            Gd = G if n_pad == n else np.pad(G, ((0, n_pad - n),
                                                 (0, n_pad - n)))
            G_dense = torch.as_tensor(Gd).to(dev, be.torch_dtype)
        return (torch.as_tensor(idx).to(dev),
                torch.as_tensor(val).to(dev, be.torch_dtype),
                G_dense)
    key_holder = _sparse_rows(G_w)    # one entry per guest object
    cache = _SPARSE_DEV_CACHE.get(key_holder, dict)
    sub = (n_pad, be.dtype, str(dev))
    if sub not in cache:
        cache[sub] = build()
    return cache[sub]


class _Dist:
    """The distance accessors of the refine/score loops over one of three
    device operands: a dense symmetrised (N, N) matrix, an (N, ndim)
    torus coordinate table with its ``dims``, or fat-tree (N, 3)
    coordinates with their per-endpoint ``penalty`` vector
    (:class:`repro_torch.core.lazydist.FatTreeLazyDistance`)."""

    def __init__(self, table: torch.Tensor, kind: str = "dense",
                 dims: tuple = (), scale: float = 1.0,
                 penalty: torch.Tensor | None = None):
        self.table, self.kind, self.dims = table, kind, tuple(dims)
        self.scale, self.penalty = scale, penalty

    def elems(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """D[u, v] for broadcastable int64 node-id tensors (plain torch)."""
        T = self.table
        if self.kind == "dense":
            return T[u, v]
        if self.kind == "torus":
            return self.scale * torus_hop_elems_ref(T[u], T[v], self.dims)
        # c * hops + endpoint penalties — same expression (and summation
        # order) as FatTreeLazyDistance._elems
        hops = self.scale * fattree_hop_elems_ref(T[u], T[v])
        pen = self.penalty
        return hops + torch.where(u != v, pen[u] + pen[v], 0.0)

    def all_pairs(self, P: torch.Tensor) -> torch.Tensor:
        """(B, n) placements -> (B, n, n) gathered distances; the
        implicit kinds build it with the CUDA hop kernels on a GPU."""
        T = self.table
        if self.kind == "dense":
            return T[P[:, :, None], P[:, None, :]]
        c = T[P]                                          # (B, n, ndim)
        if self.kind == "torus":
            return self.scale * hop_ops.torus_hop(c, c, self.dims)
        hops = self.scale * hop_ops.fattree_hop(c, c)
        pen = self.penalty[P]
        return hops + torch.where(P[:, :, None] != P[:, None, :],
                                  pen[:, :, None] + pen[:, None, :], 0.0)

    def row(self, node: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """(B,) nodes, (B, n) placements -> (B, n) distance rows."""
        return self.elems(node[:, None], p)


def _device_distances(D, be, device=None) -> _Dist:
    """The dense symmetrised matrix, or the implicit spec's coordinate
    table (and fat-tree penalty vector) on ``device`` (by default the
    backend's)."""
    spec = getattr(D, "implicit", None)
    if spec is None:
        return _Dist(be.device_matrix(_sym_host(D), device))
    if getattr(spec, "kind", "torus") == "fattree":
        return _Dist(be.device_matrix(spec.coords, device), "fattree",
                     scale=float(spec.scale),
                     penalty=be.device_matrix(spec.penalty, device))
    return _Dist(be.device_matrix(spec.coords, device), "torus",
                 dims=spec.dims, scale=float(spec.scale))


# --------------------------------------------------------------------------
# pairwise-swap refinement
# --------------------------------------------------------------------------

def _refine(p: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
            G_dense: torch.Tensor | None, dist: _Dist, n_valid: int, *,
            movers: int, total_passes: int) -> torch.Tensor:
    """Refine a (B, n) stack of placements; decision-identical to the
    NumPy loop run on each row.

    ``p`` (B, n) int64 node ids (tail >= n_valid is masked padding),
    ``idx``/``val`` (n, k) CSR-padded guest rows, ``G_dense`` (n, n) on
    the dense branch (else None).  ``p`` is updated in place.
    """
    B, n = p.shape
    dev, fdt = p.device, val.dtype
    ar = torch.arange(B, device=dev)
    valid = torch.arange(n, device=dev) < n_valid               # (n,)
    nv = torch.tensor([n_valid], dtype=torch.int32, device=dev)
    dense = G_dense is not None
    val_b = val.unsqueeze(0)                                    # (1, n, k)

    M = dist.all_pairs(p)                                       # (B, n, n)
    contrib = (val_b * torch.gather(
        M, 2, idx.unsqueeze(0).expand(B, -1, -1))).sum(-1)      # (B, n)

    def select_mover(i):
        """(best gain, partner j) per candidate — the fused gains row +
        masked argmax + accept step; ``j == i`` encodes a rejection."""
        if dense:
            return swap_select(M, G_dense, contrib, i, nv)
        # M is kept exactly symmetric, so every column read below is a
        # (contiguous) row read instead
        idx_i, val_i = idx[i], val[i]                           # (B, k)
        Mrow_i = M[ar, i]                                       # (B, n)
        a = torch.bmm(val_i.unsqueeze(1),
                      M[ar[:, None], idx_i]).squeeze(1)         # M @ G[i]
        b = (val_b * Mrow_i[:, idx]).sum(-1)                    # G @ M[i]
        Ci = torch.zeros(B, n, dtype=fdt, device=dev).scatter_add_(
            1, idx_i, val_i * Mrow_i.gather(1, idx_i))
        g = contrib[ar, i].unsqueeze(1) + contrib - 2.0 * Ci - a - b
        g[ar, i] = 0.0
        g = torch.where(valid, g, -_INF)
        j_raw = g.argmax(dim=1)
        gain = g[ar, j_raw]
        j = torch.where((gain > GAIN_EPS) & (i < n_valid), j_raw, i)
        return gain, j

    def mover_step(i, active):
        nonlocal contrib
        gain, j = select_mover(i)
        do = active & (i < n_valid) & (gain > GAIN_EPS)
        # rejected (or stopped) candidates take the identity swap j == i:
        # the M updates below then rewrite rows with their current exact
        # values, so no masked select of the (B, n, n) matrix is needed
        j = torch.where(do, j, i)
        oi, oj = p[ar, i], p[ar, j]
        # pre-swap rows, needed by the contrib delta
        if dense:
            old_row_i, old_row_j = dist.row(oi, p), dist.row(oj, p)
        else:
            ii, vi = idx[i], val[i]
            ij, vj = idx[j], val[j]
            old_i_k = dist.elems(oi[:, None], p.gather(1, ii))
            old_j_k = dist.elems(oj[:, None], p.gather(1, ij))
        p[ar, i] = oj
        p[ar, j] = oi
        # every M entry is a directly gathered distance (never
        # accumulated), so rows are recomputed instead of read out of M
        row_i, row_j = dist.row(oj, p), dist.row(oi, p)
        M[ar, i, :] = row_i
        M[ar, :, i] = row_i
        M[ar, j, :] = row_j
        M[ar, :, j] = row_j
        rij = row_i[ar, j]
        M[ar, i, j] = rij
        M[ar, j, i] = rij
        if dense:
            Gi, Gj = G_dense[i], G_dense[j]
            c1 = contrib + (Gi * (row_i - old_row_i)
                            + Gj * (row_j - old_row_j))
            c1[ar, i] = (Gi * row_i).sum(-1)
            c1[ar, j] = (Gj * row_j).sum(-1)
        else:
            # the sparse delta only needs the rows at the k nonzero
            # columns; built separately then added, matching the NumPy
            # fused-expression summation order
            ri_k, rj_k = row_i.gather(1, ii), row_j.gather(1, ij)
            delta = torch.zeros(B, n, dtype=fdt, device=dev)
            delta.scatter_add_(1, ii, vi * (ri_k - old_i_k))
            delta.scatter_add_(1, ij, vj * (rj_k - old_j_k))
            c1 = contrib + delta
            c1[ar, i] = (vi * ri_k).sum(-1)
            c1[ar, j] = (vj * rj_k).sum(-1)
        # contrib accumulates across swaps, so a rejected mover must keep
        # the accumulated values exactly — an O(B n) select, unlike M
        contrib = torch.where(do[:, None], c1, contrib)
        return do

    active = torch.ones(B, dtype=torch.bool, device=dev)
    for _ in range(total_passes):
        key = torch.where(valid, contrib, -_INF)
        # stable ascending sort of (0 - key) == np.argsort(-key,
        # kind="stable"): descending key, ties broken by index.  0.0 - x
        # never yields -0.0, so a zero contribution sorts as one value
        # whatever its sign bit (numpy compares -0.0 == 0.0)
        order = torch.sort(0.0 - key, dim=1, stable=True).indices
        improved = torch.zeros(B, dtype=torch.bool, device=dev)
        for t in range(movers):
            improved |= mover_step(order[:, t].contiguous(), active)
        active = improved
        if not bool(active.any()):       # the pass's one host sync
            break
    return p


@_timed
def refine_many(G_w: np.ndarray, D, placements: np.ndarray,
                max_passes: int = 3, movers: int = 64,
                extra_passes: int = 13) -> np.ndarray:
    """Batched ``_pairwise_refine``: (B, n) placements, one batched loop
    on the backend's device.

    With several devices (``TorchBackend.devices``) the candidate stack is
    sharded across them: B is padded to a multiple of the device count by
    repeating the last candidate, each device refines its slice (one
    thread each, so each slice's loop stops when its own candidates
    converge), and the slices are gathered and the padding cut off.
    Candidates never interact, so the result is the one-device one."""
    be = _be()
    P, n, n_pad = _pad_placements(np.atleast_2d(placements))
    B = P.shape[0]
    n_dev = min(len(be.devices), B)
    devices = be.devices[:n_dev] if n_dev > 1 else [be.device]
    if n_dev > 1:
        P = np.pad(P, ((0, (-B) % len(devices)), (0, 0)), mode="edge")
        be.stats["sharded_dispatches"] = (
            be.stats.get("sharded_dispatches", 0) + 1)
    # every transfer on this thread, before the slices run side by side
    jobs = [(torch.tensor(part, device=dev),        # a copy: refined in place
             *_guest_device(G_w, n_pad, be, dev),
             _device_distances(D, be, dev))
            for dev, part in zip(devices, np.split(P, len(devices)))]

    def run(job):
        return _refine(*job, n, movers=min(movers, n_pad),
                       total_passes=max_passes + extra_passes).cpu()

    if len(jobs) == 1:
        outs = [run(jobs[0])]
    else:
        with ThreadPoolExecutor(len(jobs)) as pool:
            outs = list(pool.map(run, jobs))
    out = torch.cat(outs).numpy()[:B, :n].astype(np.int64)
    return out if np.asarray(placements).ndim == 2 else out[0]


def pairwise_refine(G_w: np.ndarray, D, placement: np.ndarray,
                    max_passes: int = 3, movers: int = 64,
                    extra_passes: int = 13) -> np.ndarray:
    """Drop-in for :func:`repro_torch.core.mapping._pairwise_refine`."""
    return refine_many(G_w, D, np.asarray(placement)[None, :],
                       max_passes=max_passes, movers=movers,
                       extra_passes=extra_passes)[0]


# --------------------------------------------------------------------------
# hop-bytes scoring
# --------------------------------------------------------------------------

@_timed
def hop_bytes_batch(G_w: np.ndarray, D, placements: np.ndarray
                    ) -> np.ndarray:
    """Batched hop-bytes on device; bit-equal to the NumPy gather."""
    be = _be()
    P, n, n_pad = _pad_placements(np.atleast_2d(np.asarray(placements)))
    idx, val, _ = _guest_device(G_w, n_pad, be)
    dist = _device_distances(D, be)
    p = torch.as_tensor(P).to(be.device)                    # (B, n_pad)
    d = dist.elems(p[:, :, None], p[:, idx])                # (B, n_pad, k)
    ok = (torch.arange(n_pad, device=be.device) < n)[:, None]
    out = 0.5 * torch.where(ok, val * d.to(val.dtype), 0.0).sum((1, 2))
    return out.cpu().numpy().astype(np.float64)


def hop_bytes(G_w: np.ndarray, D, placement: np.ndarray) -> float:
    return float(hop_bytes_batch(G_w, D, np.asarray(placement)[None, :])[0])


# --------------------------------------------------------------------------
# node-subset selection (frontier growth)
# --------------------------------------------------------------------------

@_timed
def select_nodes(D: np.ndarray, count: int,
                 seed: int | None = None) -> np.ndarray:
    """Drop-in for :func:`repro_torch.core.mapping.select_nodes` — the
    O(N^2) seed search stays on host (one partition, same arithmetic as
    NumPy); the sequential frontier growth runs on the device with no
    host sync inside the loop."""
    n = D.shape[0]
    count = min(count, n)
    if seed is None:
        part = np.partition(D, count - 1, axis=1)[:, :count]
        seed = int(np.argmin(part.sum(axis=1)))
    be = _be()
    Ddev = be.device_matrix(np.asarray(D, dtype=np.float64))
    chosen = torch.zeros(n, dtype=torch.bool, device=be.device)
    chosen[seed] = True
    cost = Ddev[seed].clone()
    cost[seed] = _INF
    for _ in range(count - 1):
        nxt = cost.argmin().view(1)
        chosen.index_fill_(0, nxt, True)
        cost += Ddev.index_select(0, nxt)[0]       # +inf entries stay +inf
        cost.index_fill_(0, nxt, _INF)
    return np.flatnonzero(chosen.cpu().numpy()).astype(np.int64)


# --------------------------------------------------------------------------
# greedy pair placement (paper baseline)
# --------------------------------------------------------------------------

@_timed
def greedy_placement(G_w: np.ndarray, nodes: np.ndarray,
                     D: np.ndarray) -> np.ndarray:
    """Drop-in for :func:`repro_torch.core.mapping.greedy_placement`: the
    traffic-sorted pair list is built on host (identical ordering); the
    frontier loop runs on the device against the resident distances.

    Each pair step is branchless — the case (both unplaced, one unplaced,
    neither) is a device predicate selecting between candidate node ids —
    so the loop never waits on the device.  Ties break to the lowest node
    id (first-occurrence argmin/argmax), as in the NumPy frontier.
    """
    n = G_w.shape[0]
    nodes = np.asarray(nodes)
    iu = np.triu_indices(n, 1)
    w = np.asarray(G_w)[iu]
    order = np.argsort(-w, kind="stable")
    order = order[w[order] > 0]
    pair_i = iu[0][order].tolist()
    pair_j = iu[1][order].tolist()

    be = _be()
    dev = be.device
    Ddev = be.device_matrix(np.asarray(D, dtype=np.float64))
    free0 = np.zeros(D.shape[0], dtype=bool)
    free0[np.unique(nodes)] = True
    free = torch.as_tensor(free0).to(dev)
    pl = torch.full((n,), -1, dtype=torch.int64, device=dev)

    def nearest_free(anchor):
        row = Ddev.index_select(0, anchor.view(1))[0]
        return torch.where(free, row, _INF).argmin()

    def take(node, when):
        at = node.view(1)
        free.index_put_((at,), free.index_select(0, at) & ~when.view(1))

    for i, j in zip(pair_i, pair_j):
        pi, pj = pl[i].clone(), pl[j].clone()
        ni, nj = pi < 0, pj < 0
        both, only_j = ni & nj, ~ni & nj
        # first pick: the lowest free id (both unplaced), else the free
        # node nearest the placed partner
        near = nearest_free(torch.where(ni, pj, pi).clamp(min=0))
        a = torch.where(both, free.to(torch.uint8).argmax(), near)
        take(a, ni | nj)
        # second pick (both unplaced): the free node nearest the first
        b = nearest_free(a)
        take(b, both)
        pl[i] = torch.where(ni, a, pi)
        pl[j] = torch.where(both, b, torch.where(only_j, a, pj))
    placement = pl.cpu().numpy()
    free_ids = np.flatnonzero(free.cpu().numpy())
    rem = np.flatnonzero(placement < 0)
    placement[rem] = free_ids[:len(rem)]
    return placement
