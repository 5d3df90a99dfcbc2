"""Graph mapping: the Scotch dual-recursive-bipartitioning analogue.

The paper delegates the topology-mapping problem to the Scotch library
(``ScotchMap``).  This module implements the same class of algorithm from
scratch so the framework has no external solver dependency:

* ``bisect_graph``     weighted graph bisection of the guest (communication)
                       graph via greedy graph growing + Fiduccia–Mattheyses
                       (FM) boundary refinement.
* ``bisect_nodes``     bisection of the host (topology) node set.  For
                       contiguous torus windows this is a geometric split
                       along the longest bounding-box dimension (what Scotch's
                       architecture decomposition does for ``tleaf``/mesh
                       targets); for arbitrary weighted node sets it is a
                       distance-based sweep from a peripheral seed.
* ``map_graph``        dual recursive bipartitioning: recursively co-bisect
                       (processes, nodes) and assign at the leaves.
* ``select_nodes``     when |V_H| > |V_G|, greedily grow a compact,
                       low-weight (== healthy, per Eq. 1 weighting) node
                       subset — the mechanism by which the 100x fault penalty
                       steers the mapping away from failing nodes.

Quality metric: ``hop_bytes`` = sum_{i<j} G_v[i,j] * d(place_i, place_j) —
the standard dilation-volume objective these mappers minimise.

Performance: the hot kernels (``_pairwise_refine``, ``bisect_graph``,
``select_nodes``, ``greedy_placement``) are array-level NumPy
implementations in the style of high-performance mapping codes (cf. Schulz
& Träff, "Better Process Mapping and Sparse Quadratic Assignment"):
per-process cost contributions are precomputed once, every candidate swap
gain for a mover is evaluated with one matvec over the gathered distance
matrix, and contributions are updated incrementally in O(n) after each
accepted move instead of re-gathered per pass.  The original scalar-loop
versions are retained as ``*_reference`` — they define the quality floor
the vectorized kernels are differentially tested against
(``tests/test_mapping_diff.py``) and the baseline ``benchmarks/refine_scale``
measures speedups from.

Backends: the hot kernels dispatch through :mod:`repro_torch.core.backend`.
The default is the ``torch`` backend on ``cuda`` (it raises without a
GPU): ``hop_bytes``/``hop_bytes_batch``, ``_pairwise_refine``,
``select_nodes`` and ``greedy_placement`` run the device implementations
of :mod:`repro_torch.core.mapping_torch` — decision-identical at float64
(bit-identical placements for the integer-weighted in-tree workloads),
with all candidate refinements of one mapping call batched along a
leading candidate dimension; ``device="cpu"`` runs their plain PyTorch
kernels.  The ``numpy`` backend, on request
(``backend.use("numpy")``), runs the implementations in this file,
pinned to float64.  Asymmetric guest matrices (outside the
CommGraph convention) and lazy metrics without an implicit spec are
problem types the device kernels do not serve; they run the NumPy
kernels, as in the reference.  Inside ``use_reference_impl`` the
retained scalar loops always run, regardless of backend — they are the
fixed baseline.
"""
from __future__ import annotations

import contextlib

import numpy as np

from . import backend as _backend
from .lazydist import is_lazy


def _torch_kernels(G_w: np.ndarray | None = None, D=None):
    """The device kernel module when the torch backend should serve this
    call, else None (numpy path).  ``G_w`` adds the symmetric-guest
    check for guest-dependent kernels; ``D`` adds the lazy-distance
    check — a lazy adapter is served only when the backend can compute
    its entries in-kernel (implicit spec), otherwise the NumPy kernels
    run against the adapter's ``__getitem__``."""
    be = _backend.active()
    if not getattr(be, "is_torch", False):
        return None
    from . import mapping_torch
    if G_w is not None and not mapping_torch.guest_supported(G_w):
        return None
    if D is not None and is_lazy(D) and not mapping_torch.lazy_supported(D):
        return None
    return mapping_torch


# --------------------------------------------------------------------------
# quality metrics
# --------------------------------------------------------------------------

def hop_bytes(G_v: np.ndarray, D: np.ndarray, placement: np.ndarray) -> float:
    """0.5 * sum_{ij} G_v[i,j] * D[place(i), place(j)] — lower is better.

    With the symmetric G_v convention (both directions accumulated into both
    entries) this equals sum over unordered pairs of bytes * distance; an
    asymmetric route-weight matrix D is implicitly symmetrised.
    """
    tk = _torch_kernels(G_v, D)
    if tk is not None:
        return tk.hop_bytes(G_v, D, placement)
    p = np.asarray(placement)
    return float(0.5 * (G_v * D[np.ix_(p, p)]).sum())


def hop_bytes_batch(
    G_v: np.ndarray, D: np.ndarray, placements: np.ndarray,
    max_block_elems: int = 64_000_000,
) -> np.ndarray:
    """Score a stack of candidate placements in one batched gather.

    ``placements`` is (k, n); returns (k,) hop-bytes.  The D gather is
    blocked so at most ``max_block_elems`` distance entries are materialised
    at once (the k*n*n intermediate would otherwise dominate memory for
    many candidates at large n).
    """
    P = np.asarray(placements)
    if P.ndim == 1:
        return np.array([hop_bytes(G_v, D, P)])
    tk = _torch_kernels(G_v, D)
    if tk is not None:
        return tk.hop_bytes_batch(G_v, D, P)
    k, n = P.shape
    out = np.empty(k, dtype=np.float64)
    step = max(1, int(max_block_elems // max(n * n, 1)))
    for s in range(0, k, step):
        blk = P[s:s + step]
        gathered = D[blk[:, :, None], blk[:, None, :]]   # (b, n, n)
        out[s:s + step] = 0.5 * np.einsum("ij,kij->k", G_v, gathered)
    return out


def avg_dilation(G_v: np.ndarray, D: np.ndarray, placement: np.ndarray) -> float:
    """Traffic-weighted mean hop distance."""
    tot = np.triu(G_v, 1).sum()
    if tot == 0:
        return 0.0
    return hop_bytes(G_v, D, placement) / float(tot)


# --------------------------------------------------------------------------
# guest graph bisection (greedy growing + FM refinement)
# --------------------------------------------------------------------------

def bisect_graph(
    W: np.ndarray,
    size0: int,
    rng: np.random.Generator | None = None,
    fm_passes: int | None = None,
) -> np.ndarray:
    """Bisect vertices {0..n-1} of weighted graph W into parts of size
    (size0, n - size0), minimising cut weight.  Returns a bool array
    ``in_part0`` of length n.

    Vectorized kernel: greedy growing keeps the part-0 connection vector
    masked in place (chosen entries pinned to -inf, no fresh ``np.where``
    allocation per step) and FM refinement maintains per-vertex gains
    incrementally — a swap updates ``int0`` by ``±W[:, moved]`` rows
    instead of re-summing ``W[:, in0]`` each pass — and evaluates all
    top-k x top-k pair deltas as one broadcast matrix.

    ``fm_passes`` caps FM refinement passes (one swap each); ``None``
    (default) runs until no improving pair remains — incremental gains
    make extra passes nearly free, and deeper descent keeps this kernel
    equal-or-better than the 4-pass scalar reference.
    """
    n = W.shape[0]
    assert 0 <= size0 <= n
    if size0 == 0:
        return np.zeros(n, dtype=bool)
    if size0 == n:
        return np.ones(n, dtype=bool)
    rng = rng or np.random.default_rng(0)

    # --- greedy graph growing from a peripheral (weakly connected) vertex
    deg = W.sum(axis=1)
    seed = int(np.argmin(deg))  # peripheral vertex
    in0 = np.zeros(n, dtype=bool)
    in0[seed] = True
    # connection weight of every vertex to part 0; chosen vertices are kept
    # pinned at -inf so the running argmax needs no per-step re-mask
    conn = W[seed].astype(np.float64, copy=True)
    conn[seed] = -np.inf
    for _ in range(size0 - 1):
        nxt = int(np.argmax(conn))
        if not np.isfinite(conn[nxt]):
            nxt = int(rng.choice(np.flatnonzero(~in0)))
        in0[nxt] = True
        conn += W[nxt]           # -inf entries stay -inf
        conn[nxt] = -np.inf

    # --- FM refinement: swap boundary pairs with positive combined gain.
    # gain(v) = (external weight) - (internal weight); moving v from its
    # part to the other changes the cut by -gain(v).  We do balanced *pair*
    # swaps (one from each side) so sizes stay exact.  ``int0`` (weight to
    # part 0) is maintained incrementally across passes; each pass applies
    # one swap, so n bounds the useful pass count.
    int0 = W @ in0
    max_passes = n if fm_passes is None else fm_passes
    for _ in range(max_passes):
        gain = np.where(in0, deg - 2.0 * int0, 2.0 * int0 - deg)
        side0 = np.flatnonzero(in0)
        side1 = np.flatnonzero(~in0)
        if side0.size == 0 or side1.size == 0:
            break
        a = side0[np.argsort(gain[side0])[::-1][:8]]
        b = side1[np.argsort(gain[side1])[::-1][:8]]
        # swapping u<->v: delta_cut = -(gain_u + gain_v) + 2*W[u,v]
        d = gain[a][:, None] + gain[b][None, :] - 2.0 * W[np.ix_(a, b)]
        flat = int(np.argmax(d))
        if d.flat[flat] <= 1e-12:
            break
        u, v = int(a[flat // len(b)]), int(b[flat % len(b)])
        in0[u], in0[v] = False, True
        int0 += W[:, v] - W[:, u]
    return in0


def bisect_graph_reference(
    W: np.ndarray,
    size0: int,
    rng: np.random.Generator | None = None,
    fm_passes: int = 4,
) -> np.ndarray:
    """Retained scalar-loop bisection (quality floor for differential tests)."""
    n = W.shape[0]
    assert 0 <= size0 <= n
    if size0 == 0:
        return np.zeros(n, dtype=bool)
    if size0 == n:
        return np.ones(n, dtype=bool)
    rng = rng or np.random.default_rng(0)

    deg = W.sum(axis=1)
    seed = int(np.argmin(deg))
    in0 = np.zeros(n, dtype=bool)
    in0[seed] = True
    conn = W[seed].copy()
    for _ in range(size0 - 1):
        conn_masked = np.where(in0, -np.inf, conn)
        nxt = int(np.argmax(conn_masked))
        if not np.isfinite(conn_masked[nxt]):
            nxt = int(rng.choice(np.flatnonzero(~in0)))
        in0[nxt] = True
        conn += W[nxt]

    for _ in range(fm_passes):
        int0 = W[:, in0].sum(axis=1)
        int1 = W[:, ~in0].sum(axis=1)
        gain = np.where(in0, int1 - int0, int0 - int1)
        side0 = np.flatnonzero(in0)
        side1 = np.flatnonzero(~in0)
        if side0.size == 0 or side1.size == 0:
            break
        a = side0[np.argsort(gain[side0])[::-1][:8]]
        b = side1[np.argsort(gain[side1])[::-1][:8]]
        best, pair = 0.0, None
        for u in a:
            for v in b:
                d = gain[u] + gain[v] - 2.0 * W[u, v]
                if d > best + 1e-12:
                    best, pair = d, (u, v)
        if pair is None:
            break
        u, v = pair
        in0[u], in0[v] = False, True
    return in0


def cut_weight(W: np.ndarray, in0: np.ndarray) -> float:
    """Total weight crossing the (in0, ~in0) bisection — lower is better."""
    return float(W[np.ix_(in0, ~in0)].sum())


# --------------------------------------------------------------------------
# host node-set bisection
# --------------------------------------------------------------------------

def bisect_nodes(
    nodes: np.ndarray,
    coords: np.ndarray,
    size0: int,
    D: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Split ``nodes`` into (size0, rest) keeping each half compact.

    Geometric split: order nodes along the longest bounding-box dimension of
    their coordinates (lexicographic within), take the first ``size0``.
    Falls back to a distance sweep from a peripheral node when ``D`` is
    given and coordinates are degenerate (e.g. fault-weighted selection).
    """
    nodes = np.asarray(nodes)
    if size0 <= 0:
        return nodes[:0], nodes
    if size0 >= len(nodes):
        return nodes, nodes[:0]
    sub = coords[nodes]  # (m, ndim)
    spans = sub.max(axis=0) - sub.min(axis=0)
    dim = int(np.argmax(spans))
    if spans[dim] == 0 and D is not None:
        # all nodes co-located geometrically: sweep by weighted distance
        seed_local = 0
        order = np.argsort(D[nodes[seed_local]][nodes], kind="stable")
    else:
        key = [sub[:, dim]]
        for k in range(sub.shape[1]):
            if k != dim:
                key.append(sub[:, k])
        order = np.lexsort(tuple(reversed(key)))
    ordered = nodes[order]
    return ordered[:size0], ordered[size0:]


def snake_order(nodes: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Order ``nodes`` along a boustrophedon (snake) curve of their coords.

    Consecutive nodes in the returned order are (on full grids) one hop
    apart, which makes a sequential seed near-optimal for banded guests —
    the regular-pattern regime where the paper observes default-slurm
    winning (Section 5.1, LAMMPS 256).
    """
    nodes = np.asarray(nodes)
    sub = coords[nodes].astype(np.int64)
    eff = sub.copy()
    ndim = sub.shape[1]
    for d in range(1, ndim):
        parity = sub[:, :d].sum(axis=1) % 2
        hi = sub[:, d].max() if len(sub) else 0
        eff[:, d] = np.where(parity == 1, hi - sub[:, d], sub[:, d])
    order = np.lexsort(tuple(eff[:, d] for d in reversed(range(ndim))))
    return nodes[order]


# --------------------------------------------------------------------------
# node subset selection (|V_H| > |V_G|)
# --------------------------------------------------------------------------

def select_nodes(D: np.ndarray, count: int, seed: int | None = None) -> np.ndarray:
    """Greedily grow a compact low-weight subset of ``count`` nodes.

    ``D`` is the (fault-aware) pairwise weight matrix of the full topology.
    Start from the node with the lowest total weight to its ``count``
    nearest peers (cheapest healthy region) and repeatedly add the node with
    minimum total weight to the chosen set.  The Eq. 1 fault penalty (100x)
    makes faulty nodes effectively unselectable unless unavoidable.

    The frontier cost vector is maintained in place across steps — chosen
    entries are pinned to +inf, so each step is one argmin + one row add,
    with no per-step masked copy of the full N-node array.
    """
    lazy = is_lazy(D)
    tk = None if lazy else _torch_kernels()
    if tk is not None:
        return tk.select_nodes(D, count, seed=seed)
    n = D.shape[0]
    count = min(count, n)
    if seed is None:
        if lazy:
            # blocked row generation keeps peak memory O(block * n); the
            # hierarchical policies pass an explicit seed at scale, this
            # path is the small-n / direct-call fallback
            best, seed = np.inf, 0
            step = max(1, 8_000_000 // max(n, 1))
            rows_idx = np.arange(n)
            for s in range(0, n, step):
                rows = D[rows_idx[s:s + step]]
                part = np.partition(rows, count - 1, axis=1)[:, :count]
                sums = part.sum(axis=1)
                k = int(np.argmin(sums))
                if sums[k] < best:
                    best, seed = float(sums[k]), s + k
        else:
            # cost of the best `count`-node ball centred at each node
            part = np.partition(D, count - 1, axis=1)[:, :count]
            seed = int(np.argmin(part.sum(axis=1)))
    chosen = np.zeros(n, dtype=bool)
    chosen[seed] = True
    cost = D[seed].astype(np.float64, copy=True)
    cost[seed] = np.inf
    for _ in range(count - 1):
        nxt = int(np.argmin(cost))
        chosen[nxt] = True
        cost += D[nxt]           # +inf entries stay +inf
        cost[nxt] = np.inf
    return np.flatnonzero(chosen)


def select_nodes_reference(
    D: np.ndarray, count: int, seed: int | None = None
) -> np.ndarray:
    """Retained scalar-masking subset growth (differential-test floor)."""
    n = D.shape[0]
    count = min(count, n)
    if seed is None:
        part = np.partition(D, count - 1, axis=1)[:, :count]
        seed = int(np.argmin(part.sum(axis=1)))
    chosen = np.zeros(n, dtype=bool)
    chosen[seed] = True
    cost = D[seed].copy()
    for _ in range(count - 1):
        masked = np.where(chosen, np.inf, cost)
        nxt = int(np.argmin(masked))
        chosen[nxt] = True
        cost += D[nxt]
    return np.flatnonzero(chosen)


def refine_batch(G_w: np.ndarray, D: np.ndarray, placements: np.ndarray,
                 ) -> np.ndarray:
    """Refine a (k, n) stack of candidate placements.

    On the numpy backend this loops the module-global ``_pairwise_refine``
    (so ``use_reference_impl`` still applies); on the torch backend the
    whole stack refines in one batched device call.
    """
    P = np.stack([np.asarray(p) for p in placements]) \
        if not isinstance(placements, np.ndarray) else placements
    refiner = globals()["_pairwise_refine"]
    # dispatch to the batched device refine only when the *vectorized*
    # kernel is installed — under use_reference_impl the global is the scalar
    # reference, which must run regardless of backend (compare against
    # the saved original: the bare name would resolve to the same
    # swapped global and never detect reference mode)
    if refiner is _VECTORIZED_IMPL.get("_pairwise_refine"):
        tk = _torch_kernels(G_w, D)
        if tk is not None:
            return tk.refine_many(G_w, D, P)
    return np.stack([refiner(G_w, D, p) for p in P])


def best_map(G_w, node_sets, coords, D, rng) -> np.ndarray:
    """Map onto each candidate node subset, keep the lowest hop-bytes.

    Candidate generation (dual recursive bipartitioning + snake seed per
    node set) stays host-side; *all* resulting candidates are refined as
    one ``refine_batch`` stack and scored in one ``hop_bytes_batch``
    evaluation — on the torch backend that is a single device dispatch for
    TOFA's entire multi-candidate search.  Equivalent to mapping each
    set independently and keeping the best: the global argmin over
    refined candidates is the min of the per-set minima, with the same
    first-occurrence tie-break.
    """
    candidates: list[np.ndarray] = []
    for nodes in node_sets:
        candidates += _map_candidates(G_w, np.asarray(nodes), coords, D, rng)
    refined = refine_batch(G_w, D, np.stack(candidates))
    scores = hop_bytes_batch(G_w, D, refined)
    return refined[int(np.argmin(scores))]


# --------------------------------------------------------------------------
# dual recursive bipartitioning
# --------------------------------------------------------------------------

def map_graph(
    G_w: np.ndarray,
    nodes: np.ndarray,
    coords: np.ndarray,
    D: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
    refine: bool = True,
    portfolio: bool = True,
) -> np.ndarray:
    """ScotchMap analogue: map processes {0..n-1} onto ``nodes``.

    ``G_w``    (n, n) guest edge weights (bytes, typically CommGraph.G_v)
    ``nodes``  host node ids available (len >= n)
    ``coords`` (N, ndim) coordinates of *all* host nodes (for geometric
               bisection)
    ``D``      optional (N, N) weight matrix for refinement + degenerate
               splits

    Like Scotch, runs a small strategy *portfolio*: dual recursive
    bipartitioning AND a sequential seed (which is near-optimal for banded /
    regular patterns — cf. the paper's LAMMPS discussion in Section 5.1),
    refines each with pairwise swaps, and keeps the best by hop-bytes.

    Returns placement: array of node ids, one per process.
    """
    candidates = _map_candidates(G_w, np.asarray(nodes), coords, D, rng,
                                 portfolio=portfolio)
    if D is None:
        return candidates[0]
    stack = np.stack(candidates)
    if refine:
        stack = refine_batch(G_w, D, stack)
    scores = hop_bytes_batch(G_w, D, stack)
    return stack[int(np.argmin(scores))]


def _map_candidates(
    G_w: np.ndarray,
    nodes: np.ndarray,
    coords: np.ndarray,
    D: np.ndarray | None,
    rng: np.random.Generator | None,
    portfolio: bool = True,
) -> list[np.ndarray]:
    """Unrefined candidate placements of one (guest, node set) mapping:
    dual recursive bipartitioning, plus (with ``D`` and ``portfolio``)
    the sequential snake seed.  Shared by :func:`map_graph` and
    :func:`best_map` so multi-set searches can refine every candidate in
    one batch."""
    n = G_w.shape[0]
    nodes = np.asarray(nodes)
    assert len(nodes) >= n, "not enough nodes"
    rng = rng or np.random.default_rng(0)
    placement = np.full(n, -1, dtype=np.int64)

    def rec(procs: np.ndarray, navail: np.ndarray) -> None:
        if len(procs) == 0:
            return
        if len(procs) == 1:
            # put the single proc on the first node (splits kept compact)
            placement[procs[0]] = navail[0]
            return
        half_nodes = len(navail) // 2
        # processes split proportionally to the node halves, but never more
        # procs than nodes on either side
        p0 = min(max(len(procs) * half_nodes // len(navail),
                     len(procs) - (len(navail) - half_nodes)), half_nodes)
        sub = G_w[np.ix_(procs, procs)]
        in0 = bisect_graph(sub, p0, rng=rng)
        n0, n1 = bisect_nodes(navail, coords, half_nodes, D=D)
        rec(procs[in0], n0)
        rec(procs[~in0], n1)

    rec(np.arange(n), nodes)

    if D is None:
        return [placement]
    candidates = [placement]
    if portfolio:
        # sequential seed: process i -> i-th node along a snake curve of the
        # available nodes (near-optimal chain for banded guests)
        candidates.append(snake_order(nodes, coords)[:n].copy())
    return candidates


def _pairwise_refine(
    G_w: np.ndarray, D: np.ndarray, placement: np.ndarray,
    max_passes: int = 3, movers: int = 64, extra_passes: int = 13,
) -> np.ndarray:
    """Greedy pairwise-swap refinement of a full placement under hop-bytes.

    Delta-based vectorized kernel.  State kept across swaps:

      M        = sym(D)[p, p]  — gathered pairwise distances of the placement
      C        = G_w * M       — per-pair cost terms
      contrib  = C.sum(1)      — per-process cost contribution

    For a mover ``i`` the gain of swapping with *every* ``j`` is one
    broadcast expression (two matvecs, no inner Python loop):

      gain = contrib[i] + contrib - 2*C[i] - M @ G_w[i] - G_w @ M[i]

    (the i<->j mutual term cancels because swapping endpoints preserves
    their own distance).  An accepted swap updates M, C and contrib
    incrementally in O(n) — two row/column gathers — instead of
    recomputing the O(n^2) gather per pass.

    Passes beyond ``max_passes`` (up to ``extra_passes`` more) continue only
    while improving: they are nearly free at array speed and let the refiner
    descend at least as far as the scalar reference, which stops after
    ``max_passes`` regardless.  A pass that accepts no swap leaves all state
    unchanged, so the first such pass terminates refinement.

    Mover order uses a *stable* descending sort so the swap sequence is a
    deterministic function of the inputs — the contract the torch backend's
    decision-identical port (:mod:`repro_torch.core.mapping_torch`) relies on.
    """
    p = placement.copy()
    n = len(p)
    if n <= 1:
        return p
    tk = _torch_kernels(G_w, D)
    if tk is not None:
        return tk.pairwise_refine(G_w, D, p, max_passes=max_passes,
                                  movers=movers, extra_passes=extra_passes)
    G = G_w
    if np.count_nonzero(np.diagonal(G)):
        G = G.copy()
        np.fill_diagonal(G, 0.0)
    # symmetrise lazily on the gathered submatrix (hop_bytes implicitly
    # symmetrises an asymmetric D, so the refiner must optimise the same
    # objective); for the in-tree topologies D is already symmetric
    M = D[np.ix_(p, p)].astype(np.float64)
    M = 0.5 * (M + M.T)
    C = G * M
    contrib = C.sum(axis=1)

    def gathered_row(node: int) -> np.ndarray:
        return 0.5 * (D[node, p] + D[p, node])

    for _ in range(max_passes + extra_passes):
        improved = False
        # worst offenders first; stable descending (ties keep index order)
        # so the swap sequence is deterministic and exactly replicable by
        # the torch port
        order = np.argsort(-contrib, kind="stable")[: min(n, movers)]
        for i in order:
            gains = (contrib[i] + contrib - 2.0 * C[i]
                     - M @ G[i] - G @ M[i])
            gains[i] = 0.0
            j = int(np.argmax(gains))
            if gains[j] <= 1e-9:
                continue
            # accept swap (i, j); update all state in O(n)
            p[i], p[j] = p[j], p[i]
            old_col_i, old_col_j = M[:, i].copy(), M[:, j].copy()
            row_i, row_j = gathered_row(p[i]), gathered_row(p[j])
            M[i, :] = row_i
            M[:, i] = row_i
            M[j, :] = row_j
            M[:, j] = row_j
            M[i, j] = M[j, i] = row_i[j]
            contrib += (G[:, i] * (M[:, i] - old_col_i)
                        + G[:, j] * (M[:, j] - old_col_j))
            C[i, :] = G[i] * M[i]
            C[:, i] = C[i, :]
            C[j, :] = G[j] * M[j]
            C[:, j] = C[j, :]
            contrib[i] = C[i].sum()
            contrib[j] = C[j].sum()
            improved = True
        if not improved:
            break
    return p


def _pairwise_refine_reference(
    G_w: np.ndarray, D: np.ndarray, placement: np.ndarray,
    max_passes: int = 3,
) -> np.ndarray:
    """Retained scalar-loop refiner (quality floor for differential tests).

    O(passes * movers * n^2) with Python-level inner loops — the pre-
    vectorization hot path that dominated placement wall time.
    """
    p = placement.copy()
    n = len(p)
    for _ in range(max_passes):
        improved = False
        # cost contribution of each process: c_i = sum_j G_w[i,j] D[p_i, p_j]
        Dp = D[np.ix_(p, p)]
        contrib = (G_w * Dp).sum(axis=1)
        # worst offenders, stable descending — same deterministic mover
        # order as the vectorized kernel so the comparison stays paired
        order = np.argsort(-contrib, kind="stable")[: min(n, 64)]
        for i in order:
            best_d, best_j = 0.0, -1
            mask = np.ones(n, dtype=bool)
            mask[i] = False
            for j in range(n):
                if j == i:
                    continue
                mask[j] = False
                pi, pj = p[j], p[i]  # candidate swapped assignments
                # cost with i@pi, j@pj vs current, others fixed
                new = float(G_w[i, mask] @ D[pi][p[mask]]) \
                    + float(G_w[j, mask] @ D[pj][p[mask]]) \
                    + G_w[i, j] * D[pi, pj]
                old = float(G_w[i, mask] @ D[p[i]][p[mask]]) \
                    + float(G_w[j, mask] @ D[p[j]][p[mask]]) \
                    + G_w[i, j] * D[p[i], p[j]]
                mask[j] = True
                d = old - new
                if d > best_d + 1e-9:
                    best_d, best_j = d, j
            if best_j >= 0:
                p[i], p[best_j] = p[best_j], p[i]
                improved = True
        if not improved:
            break
    return p


# --------------------------------------------------------------------------
# reference-implementation switch (differential tests / baseline benchmarks)
# --------------------------------------------------------------------------

_VECTORIZED_IMPL = {}   # populated after greedy_placement is defined


@contextlib.contextmanager
def use_reference_impl():
    """Temporarily swap the retained loop kernels into the mapping pipeline.

    Inside the context, ``map_graph``/``best_map`` (and policies that
    resolve kernels through this module) run the pre-vectorization
    implementations — the baseline that ``benchmarks/refine_scale``
    measures speedups against and differential tests compare quality with.
    """
    g = globals()
    saved = {name: g[name] for name in _VECTORIZED_IMPL}
    g.update({name: g[name + "_reference"] for name in _VECTORIZED_IMPL})
    try:
        yield
    finally:
        g.update(saved)


# --------------------------------------------------------------------------
# baseline placement policies of Section 5.1
# --------------------------------------------------------------------------

def linear_placement(n_procs: int, nodes: np.ndarray) -> np.ndarray:
    """default-slurm: iterate available nodes sequentially."""
    nodes = np.asarray(nodes)
    return nodes[:n_procs].copy()


def random_placement(
    n_procs: int, nodes: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    nodes = np.asarray(nodes)
    return rng.choice(nodes, size=n_procs, replace=False)


def greedy_placement(
    G_w: np.ndarray, nodes: np.ndarray, D: np.ndarray,
) -> np.ndarray:
    """The paper's Greedy baseline: sort process pairs by traffic, place the
    heaviest pairs as close as possible (starting from one hop).

    Vectorized: only positive-traffic pairs are sorted (the reference built
    and sorted the full O(n^2) pair list), and the free-node frontier is a
    maintained id array — nearest-free is an argmin over the shrinking
    frontier, not a masked scan of the full N-node topology per step.
    Pair order is a stable descending sort (ties keep upper-triangle
    order), the deterministic contract shared with the torch port.
    """
    tk = None if is_lazy(D) else _torch_kernels()
    if tk is not None:
        return tk.greedy_placement(G_w, nodes, D)
    n = G_w.shape[0]
    nodes = np.asarray(nodes)
    iu = np.triu_indices(n, 1)
    w = G_w[iu]
    order = np.argsort(-w, kind="stable")
    order = order[w[order] > 0]   # reference stops at the first <= 0 pair
    pair_i, pair_j = iu[0][order], iu[1][order]

    placement = np.full(n, -1, dtype=np.int64)
    # frontier of free node ids, ascending (matches the reference's
    # lowest-id tie-break for both first-free and nearest-free)
    free = np.unique(nodes)

    def take(pos_in_free: int) -> int:
        nonlocal free
        node = int(free[pos_in_free])
        free = np.delete(free, pos_in_free)
        return node

    for i, j in zip(pair_i, pair_j):
        pi, pj = placement[i], placement[j]
        if pi < 0 and pj < 0:
            a = take(0)
            placement[i] = a
            placement[j] = take(int(np.argmin(D[a, free])))
        elif pi < 0:
            placement[i] = take(int(np.argmin(D[pj, free])))
        elif pj < 0:
            placement[j] = take(int(np.argmin(D[pi, free])))
    # any untouched processes (no traffic): fill with the lowest free ids
    rem = np.flatnonzero(placement < 0)
    placement[rem] = free[:len(rem)]
    return placement


def greedy_placement_reference(
    G_w: np.ndarray, nodes: np.ndarray, D: np.ndarray,
) -> np.ndarray:
    """Retained scalar-loop greedy baseline (differential-test floor)."""
    n = G_w.shape[0]
    nodes = np.asarray(nodes)
    iu = np.triu_indices(n, 1)
    order = np.argsort(-G_w[iu], kind="stable")
    pairs = list(zip(iu[0][order], iu[1][order]))

    placement = np.full(n, -1, dtype=np.int64)
    used = np.zeros(D.shape[0], dtype=bool)
    avail_mask = np.zeros(D.shape[0], dtype=bool)
    avail_mask[nodes] = True

    def nearest_free(anchor: int) -> int:
        cand = np.where(~used & avail_mask, D[anchor], np.inf)
        return int(np.argmin(cand))

    def first_free() -> int:
        free = np.flatnonzero(~used & avail_mask)
        return int(free[0])

    for i, j in pairs:
        if G_w[i, j] <= 0:
            break
        pi, pj = placement[i], placement[j]
        if pi < 0 and pj < 0:
            a = first_free()
            placement[i] = a
            used[a] = True
            b = nearest_free(a)
            placement[j] = b
            used[b] = True
        elif pi < 0:
            a = nearest_free(pj)
            placement[i] = a
            used[a] = True
        elif pj < 0:
            b = nearest_free(pi)
            placement[j] = b
            used[b] = True
    for i in range(n):
        if placement[i] < 0:
            a = first_free()
            placement[i] = a
            used[a] = True
    return placement


_VECTORIZED_IMPL.update({
    "bisect_graph": bisect_graph,
    "select_nodes": select_nodes,
    "greedy_placement": greedy_placement,
    "_pairwise_refine": _pairwise_refine,
})
