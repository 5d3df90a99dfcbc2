"""Multilevel graph mapping: coarsen -> map -> uncoarsen-with-refinement.

The flat dual-recursive-bipartitioning mapper (:func:`mapping.map_graph`)
bisects the full guest graph at every recursion level — O(n^2) work per
level on dense guests, and its refinement sees all n processes at once.
This module implements the multilevel scheme of the process-mapping
literature (Schulz & Woydt, "Shared-Memory Hierarchical Process Mapping";
Schulz & Träff, "Better Process Mapping and Sparse Quadratic
Assignment"):

1. **Coarsen** the communication graph by heavy-edge matching (HEM)
   until at most ``coarse_target`` super-vertices remain.  Matching is
   deterministic: vertices are visited in descending weighted-degree
   order (ties by index) and matched to their heaviest unmatched
   neighbour (ties to the lowest index).
2. **Map the coarse graph** with weighted dual recursive bipartitioning:
   the super-vertex split is count-balanced FM bisection
   (:func:`mapping.bisect_graph`), and the *node-set* split adapts to
   whatever vertex weight falls on each side
   (:func:`mapping.bisect_nodes` at the exact weighted boundary) — every
   super-vertex ends up with a compact contiguous chunk of exactly its
   size in nodes.
3. **Uncoarsen**: expand each super-vertex into its children and
   recursively map them *within the parent's chunk*, then run per-level
   local delta-swap refinement (:func:`mapping._pairwise_refine` on the
   chunk subproblem) followed by a global
   :func:`mapping.refine_batch` pass over the final candidates.

Mapping work per level is proportional to the level's vertex count, so
total work is a geometric series dominated by the finest level — the
flat mapper's repeated full-graph bisections disappear.  Combined with a
:class:`~repro_torch.core.lazydist.LazyDistance` host metric, placements at
64k nodes never materialise an O(N^2) object.

``hierarchical_select`` is the companion node-subset search for lazy
metrics: it picks candidate regions group-first (racks / sub-tori from
``Topology.hierarchy_groups``), touching only a #groups x #groups
representative distance block instead of the full matrix.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from . import mapping


class Level(NamedTuple):
    """One coarsening step: ``match`` maps each vertex of the *fine*
    graph ``G`` (with vertex weights ``sizes``) to its coarse vertex."""

    match: np.ndarray   # (n_fine,) fine vertex -> coarse vertex id
    G: np.ndarray       # (n_fine, n_fine) fine guest graph
    sizes: np.ndarray   # (n_fine,) fine vertex weights (original procs)


def coarsen_level(G: np.ndarray, sizes: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One heavy-edge-matching pass: returns (match, G_coarse, sizes_c).

    Deterministic: descending weighted-degree visit order with
    index tie-break, heaviest-unmatched-neighbour matching with
    lowest-index tie-break (``argmax`` keeps the first maximum).
    Unmatchable vertices (no positive edge to an unmatched neighbour)
    become singletons.
    """
    n = G.shape[0]
    deg = G.sum(axis=1)
    order = np.lexsort((np.arange(n), -deg))
    mate = np.full(n, -1, dtype=np.int64)
    for v in order:
        if mate[v] >= 0:
            continue
        row = G[v].copy()
        row[v] = 0.0
        row[mate >= 0] = 0.0
        u = int(np.argmax(row))
        if row[u] > 0.0:
            mate[v] = u
            mate[u] = v
        else:
            mate[v] = v
    match = np.full(n, -1, dtype=np.int64)
    nc = 0
    for v in range(n):
        if match[v] < 0:
            match[v] = nc
            u = mate[v]
            if u != v:
                match[u] = nc
            nc += 1
    flat = match[:, None] * nc + match[None, :]
    Gc = np.bincount(flat.ravel(), weights=G.ravel(),
                     minlength=nc * nc).reshape(nc, nc)
    np.fill_diagonal(Gc, 0.0)
    sizes_c = np.bincount(match, weights=sizes.astype(np.float64),
                          minlength=nc).astype(np.int64)
    return match, Gc, sizes_c


def coarsen(G_w: np.ndarray, target: int
            ) -> tuple[list[Level], np.ndarray, np.ndarray]:
    """Repeated HEM until <= ``target`` vertices or matching stalls
    (< 5% shrink).  Returns (levels, G_coarse, sizes_coarse); an empty
    level list means coarsening was a no-op (n <= target already)."""
    G = np.asarray(G_w, dtype=np.float64)
    sizes = np.ones(G.shape[0], dtype=np.int64)
    levels: list[Level] = []
    while G.shape[0] > target:
        match, Gc, sizes_c = coarsen_level(G, sizes)
        if Gc.shape[0] > 0.95 * G.shape[0]:
            break
        levels.append(Level(match, G, sizes))
        G, sizes = Gc, sizes_c
    return levels, G, sizes


def uncoarsen_map(levels: list[Level], placement_like=None):
    """Compose the per-level matchings: returns ``labels`` where
    ``labels[k][p]`` is the coarse-vertex id of original process ``p``
    after ``k+1`` coarsening steps (used by round-trip tests)."""
    labels = []
    cur = None
    for lvl in levels:
        cur = lvl.match if cur is None else lvl.match[cur]
        labels.append(cur)
    return labels


def _children_lists(match: np.ndarray, nc: int) -> list[np.ndarray]:
    """Per-coarse-vertex fine-vertex id arrays, one argsort per level."""
    order = np.argsort(match, kind="stable")
    bounds = np.searchsorted(match[order], np.arange(nc + 1))
    return [order[bounds[v]:bounds[v + 1]] for v in range(nc)]


def _weighted_drb(G: np.ndarray, sizes: np.ndarray, navail: np.ndarray,
                  coords: np.ndarray, D, rng) -> list[np.ndarray]:
    """Weighted dual recursive bipartitioning: assign each vertex a
    contiguous node chunk of exactly ``sizes[v]`` nodes.  The vertex
    split is count-balanced; the node split lands on the weighted
    boundary the vertex split produced."""
    chunks: list[Optional[np.ndarray]] = [None] * len(sizes)

    def rec(verts: np.ndarray, nodes: np.ndarray) -> None:
        if len(verts) == 1:
            chunks[int(verts[0])] = nodes
            return
        half = len(verts) // 2
        in0 = mapping.bisect_graph(G[np.ix_(verts, verts)], half, rng=rng)
        w0 = int(sizes[verts[in0]].sum())
        n0, n1 = mapping.bisect_nodes(nodes, coords, w0, D=D)
        rec(verts[in0], n0)
        rec(verts[~in0], n1)

    rec(np.arange(len(sizes)), np.asarray(navail))
    return chunks


# chunk-local refinement window: chunks smaller than this refine as one
# dense subproblem during uncoarsening; larger chunks are left to their
# children's own refinement (their subgraph gather would dominate)
_LOCAL_REFINE_MAX = 1024


def multilevel_map(G_w: np.ndarray, nodes: np.ndarray, coords: np.ndarray,
                   D=None, rng: np.random.Generator | None = None,
                   coarse_target: int = 160,
                   refine: bool = True) -> np.ndarray:
    """Multilevel analogue of :func:`mapping.map_graph`.

    Coarsening a guest already at/below ``coarse_target`` is a no-op, and
    the call degrades to exactly ``map_graph`` — the bit-identity anchor
    the parity tests pin.
    """
    n = G_w.shape[0]
    nodes = np.asarray(nodes)
    assert len(nodes) >= n, "not enough nodes"
    rng = rng or np.random.default_rng(0)
    if len(nodes) > n:
        nodes = mapping.snake_order(nodes, coords)[:n]

    levels, Gc, sizes_c = coarsen(G_w, coarse_target)
    if not levels:
        return mapping.map_graph(G_w, nodes, coords, D=D, rng=rng,
                                 refine=refine)

    placement = np.full(n, -1, dtype=np.int64)

    def descend(li: int, members: np.ndarray, chunk: np.ndarray) -> None:
        """Map ``members`` (vertices of levels[li].G) onto ``chunk``."""
        lvl = levels[li]
        if len(members) == 1:
            sub_chunks = [np.asarray(chunk)]
        else:
            sub_chunks = _weighted_drb(
                lvl.G[np.ix_(members, members)], lvl.sizes[members],
                chunk, coords, D, rng)
        if li == 0:
            for local, m in enumerate(members):
                placement[m] = sub_chunks[local][0]
            return
        kids = _children_by_level[li - 1]
        for local, m in enumerate(members):
            descend(li - 1, kids[int(m)], sub_chunks[local])
        # local uncoarsening refinement: the original processes under
        # ``members`` now occupy ``chunk``; polish their arrangement
        # against the *global* metric restricted to this subproblem
        if refine and D is not None:
            procs = _procs_by_level[li - 1]
            F = np.concatenate([procs[int(m)] for m in members]) \
                if len(members) > 1 else procs[int(members[0])]
            if 4 <= len(F) <= _LOCAL_REFINE_MAX:
                refiner = mapping.__dict__["_pairwise_refine"]
                placement[F] = refiner(
                    G_w[np.ix_(F, F)], D, placement[F])

    # children of a level-li coarse vertex (vertices of levels[li].G),
    # and the original processes each level-li vertex represents
    _children_by_level = [
        _children_lists(lvl.match, int(lvl.match.max()) + 1)
        for lvl in levels]
    labels = uncoarsen_map(levels)
    _procs_by_level = [
        _children_lists(lab, int(lab.max()) + 1) for lab in labels]

    top_chunks = _weighted_drb(Gc, sizes_c, nodes, coords, D, rng)
    top_kids = _children_by_level[-1]
    for v in range(Gc.shape[0]):
        descend(len(levels) - 1, top_kids[v], top_chunks[v])

    assert (placement >= 0).all()
    if D is None:
        return placement

    # final global polish + snake portfolio — same candidate contract as
    # the flat mapper, so multilevel can never lose to the sequential
    # seed it would otherwise have skipped
    candidates = np.stack([placement,
                           mapping.snake_order(nodes, coords)[:n]])
    if refine:
        candidates = mapping.refine_batch(G_w, D, candidates)
    scores = mapping.hop_bytes_batch(G_w, D, candidates)
    return candidates[int(np.argmin(scores))]


# --------------------------------------------------------------------------
# hierarchical node-subset selection (lazy metrics)
# --------------------------------------------------------------------------

def hierarchical_select(D, groups: np.ndarray, count: int,
                        healthy: np.ndarray | None = None,
                        seed_group: int | None = None) -> np.ndarray:
    """Grow a compact ``count``-node subset group-first.

    ``groups`` is the (N,) rack/sub-torus id vector from
    ``Topology.hierarchy_groups``; ``healthy`` an optional (N,) bool
    mask.  Only a (#groups, #groups) representative distance block and
    per-node rows of ``D`` are ever materialised — the full-matrix
    ``select_nodes`` seed search is O(N^2) and off the table for lazy
    metrics.  ``seed_group`` forces growth to start from a specific
    *group id* (e.g. the rack farthest from any fault) instead of the
    cheapest-ball search.  Returns sorted node ids.
    """
    groups = np.asarray(groups)
    N = len(groups)
    if healthy is None:
        healthy = np.ones(N, dtype=bool)
    count = min(count, int(healthy.sum()))
    ng = int(groups.max()) + 1
    cap = np.bincount(groups[healthy], minlength=ng)
    live = np.flatnonzero(cap > 0)
    # lowest healthy id represents each live group
    first = np.full(ng, -1, dtype=np.int64)
    hid = np.flatnonzero(healthy)
    # reversed so the lowest id wins the final write
    first[groups[hid[::-1]]] = hid[::-1]
    reps = first[live]
    R = np.asarray(D[reps[:, None], reps[None, :]], dtype=np.float64)

    if seed_group is not None:
        hits = np.flatnonzero(live == seed_group)
        gseed = int(hits[0]) if hits.size else 0
    else:
        # seed group: cheapest capacity-weighted ball over group reps
        order = np.argsort(R, axis=1, kind="stable")
        cap_o = cap[live][order]
        cum = np.cumsum(cap_o, axis=1)
        need = np.argmax(cum >= count, axis=1)
        costs = np.where(
            cum[:, -1] >= count,
            np.take_along_axis(
                np.cumsum(R[np.arange(len(live))[:, None], order]
                          * cap_o, axis=1),
                need[:, None], axis=1)[:, 0],
            np.inf)
        gseed = int(np.argmin(costs))

    # frontier growth over groups; overshoot by ~1/2 so the node-granular
    # finish below has real boundary slack to carve a compact ball from
    # (the dense finish is O(|sup|^2) = O(count^2) either way)
    target = min(count + max(count // 2, 8), int(cap[live].sum()))
    chosen = np.zeros(len(live), dtype=bool)
    chosen[gseed] = True
    got = int(cap[live[gseed]])
    cost = R[gseed].copy()
    cost[gseed] = np.inf
    picks = [gseed]
    while got < target and len(picks) < len(live):
        nxt = int(np.argmin(cost))
        chosen[nxt] = True
        got += int(cap[live[nxt]])
        cost += R[nxt]
        cost[nxt] = np.inf
        picks.append(nxt)

    sup = np.sort(np.concatenate(
        [np.flatnonzero(healthy & (groups == live[g])) for g in picks]))
    if len(sup) == count:
        return sup
    # node-granular finish: compact growth *within* the group superset —
    # a (|sup|, |sup|) dense subproblem, |sup| <= count + one group, so
    # cost is O(count^2) like the guest matrix itself, never O(N^2)
    Dsub = np.asarray(D[np.ix_(sup, sup)], dtype=np.float64)
    seed_id = int(first[live[gseed]])
    local_seed = int(np.searchsorted(sup, seed_id))
    sel = mapping.select_nodes(Dsub, count, seed=local_seed)
    return np.sort(sup[sel])
