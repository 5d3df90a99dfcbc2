"""TOFA — TOpology and Fault-Aware process placement (paper Listing 1.1).

    procedure TOFA(G, H):
        S = find |V_G| consecutive nodes s.t. p_f = 0
        if S != {}:
            H_s := ScotchExtract(H, S)
            T   := ScotchMap(G, H_s)
        else:
            T   := ScotchMap(G, H)     # H fault-weighted per Eq. (1)

``map_graph`` (our Scotch analogue) plays ScotchMap; extraction is matrix
restriction.  When no consecutive fault-free window exists, the guest is
mapped onto a compact subset grown under the Eq. 1-weighted metric, which is
how the 100x penalty steers placement away from failing nodes while
tolerating them if unavoidable (the trade-off discussed in Section 3).

Two registrations share this module: flat ``tofa`` (the paper listing,
full-graph DRB) and ``tofa-ml`` (the same candidate search with the
multilevel coarsen->map->refine mapper of :mod:`repro_torch.core.multilevel`).
Above the engine's lazy-distance threshold both run the multilevel /
hierarchical path — the flat mapper's full-matrix operations are
undefined on a :class:`~repro_torch.core.lazydist.LazyDistance` metric.
"""
from __future__ import annotations

import numpy as np

from .. import mapping, multilevel
from ..topology import find_consecutive_healthy
from .base import PolicyContext, PolicyOutput, register_policy

# additive weight that makes a node effectively unselectable (used to mask
# faulty nodes out of ball extraction during TOFA step 14)
FAULT_BLOCK = 1e9


def _healthy_window_starts(p_f: np.ndarray, count: int) -> list[int]:
    """Start ids of all length->=count runs of healthy nodes (non-overlapping
    step count//2 within a run, to bound candidate count)."""
    healthy = p_f == 0
    starts: list[int] = []
    i, n = 0, len(p_f)
    while i + count <= n:
        if healthy[i:i + count].all():
            starts.append(i)
            i += max(count // 2, 1)
        else:
            # jump past the first unhealthy node in the window
            bad = i + int(np.argmax(~healthy[i:i + count]))
            i = bad + 1
    return starts


@register_policy("tofa")
class TofaPolicy:
    """Listing 1.1: consecutive-healthy window first, Eq. 1 fallback."""

    fault_aware = True

    def place(self, ctx: PolicyContext) -> PolicyOutput:
        n = ctx.n_procs
        G_w = ctx.G_w
        coords = ctx.coords
        rng = ctx.rng
        W = ctx.weights                       # Eq. 1 weights on H (cached)

        if mapping.is_lazy(W):
            # above the lazy threshold the flat candidate search (full-
            # matrix select_nodes / np.ix_ restrictions) cannot run —
            # the multilevel policy's hierarchical path serves "tofa"
            return TofaMultilevelPolicy._place_lazy(ctx, W)

        # Candidate node-set generation depends only on (health, n) — never
        # on the guest traffic — so it is memoised in the engine's
        # per-(topology, health) shared cache: batch simulations placing
        # hundreds of same-size jobs against one health snapshot grow the
        # window/ball candidates once.
        used_window, candidates = ctx.memo(
            ("tofa-candidates", n), lambda: self._candidates(ctx, W))

        if used_window:
            placement = mapping.best_map(G_w, candidates, coords, W, rng)
            return PolicyOutput(placement, used_consecutive_window=True)
        placement = mapping.map_graph(G_w, candidates[0], coords, D=W, rng=rng)
        return PolicyOutput(placement, used_consecutive_window=False)

    @staticmethod
    def _candidates(ctx: PolicyContext, W: np.ndarray
                    ) -> tuple[bool, list[np.ndarray]]:
        """Candidate node subsets: (found_consecutive_window, node sets)."""
        n = ctx.n_procs
        p_f = ctx.p_f
        S = find_consecutive_healthy(p_f, n)
        if S is not None:
            # steps 14-15: extract sub-topology, map onto it.  Listing 1.1's
            # H carries Eq. 1 weights *before* extraction, so mapping quality
            # is still judged fault-aware: a window placement whose internal
            # routes cross a faulty node is priced at 100x and avoided.
            # Several extraction shapes are tried (ScotchExtract is free to
            # return any sub-arch): consecutive-id windows (slabs — ideal for
            # banded guests) and compact balls grown from seeds spread across
            # the healthy region; more candidates raise the odds of a region
            # whose internal routes are entirely fault-free, which keeps full
            # mapping quality *and* zero abort exposure.
            W_sel = W + (FAULT_BLOCK * ((p_f[:, None] > 0) | (p_f[None, :] > 0)))
            candidates = [S]
            healthy = np.flatnonzero(p_f == 0)
            # additional healthy windows beyond the first
            run_starts = _healthy_window_starts(p_f, n)
            for s0 in run_starts[1:4]:
                candidates.append(np.arange(s0, s0 + n))
            # balls from diverse seeds: default (cheapest region) + the
            # healthy nodes farthest from any fault
            candidates.append(mapping.select_nodes(W_sel, n))
            if (p_f > 0).any():
                dist_to_fault = W[:, p_f > 0].min(axis=1)
                far = healthy[np.argsort(dist_to_fault[healthy])[::-1]]
                for seed_node in far[:3]:
                    candidates.append(
                        mapping.select_nodes(W_sel, n, seed=int(seed_node)))
            return True, candidates

        # step 12: map onto the full fault-weighted topology.  Weighted
        # selection grows the cheapest (healthiest, most compact) subset.
        # Improvement over plain Eq. 1 (see DESIGN.md): when >= n healthy
        # nodes exist, restrict selection to them outright — Eq. 1 alone can
        # tie a directly-faulty node with healthy nodes whose routes merely
        # *pass through* faults, and lose that tie.  Faulty nodes are used
        # only when the job cannot fit on healthy ones (the paper's
        # tolerance trade-off).
        healthy = np.flatnonzero(p_f == 0)
        if len(healthy) >= n:
            sub = mapping.select_nodes(W[np.ix_(healthy, healthy)], n)
            nodes = healthy[sub]
        else:
            nodes = mapping.select_nodes(W, n)
        return False, [nodes]


@register_policy("tofa-ml")
class TofaMultilevelPolicy(TofaPolicy):
    """TOFA candidate search + multilevel coarsen->map->refine mapper.

    Below ``COARSE_TARGET`` processes, coarsening is a no-op and the
    policy delegates to flat :class:`TofaPolicy` outright — placements
    are bit-identical (the parity anchor of ``tests/test_multilevel.py``).
    With a lazy metric (engine above its size threshold) the candidate
    search itself goes hierarchical: the consecutive-healthy window scan
    is O(N), and the fallback ball is grown rack-first over
    ``Topology.hierarchy_groups`` representatives
    (:func:`repro_torch.core.multilevel.hierarchical_select`).
    """

    fault_aware = True
    COARSE_TARGET = 160

    def place(self, ctx: PolicyContext) -> PolicyOutput:
        n = ctx.n_procs
        W = ctx.weights
        if mapping.is_lazy(W):
            return self._place_lazy(ctx, W)
        if n <= self.COARSE_TARGET:
            # coarsening would be a no-op: run the flat policy unchanged
            return TofaPolicy.place(self, ctx)
        used_window, candidates = ctx.memo(
            ("tofa-candidates", n), lambda: self._candidates(ctx, W))
        placements = np.stack([
            multilevel.multilevel_map(ctx.G_w, nodes, ctx.coords, D=W,
                                      rng=ctx.rng,
                                      coarse_target=self.COARSE_TARGET)
            for nodes in candidates])
        scores = mapping.hop_bytes_batch(ctx.G_w, W, placements)
        return PolicyOutput(placements[int(np.argmin(scores))],
                            used_consecutive_window=used_window)

    @classmethod
    def _place_lazy(cls, ctx: PolicyContext, W) -> PolicyOutput:
        n = ctx.n_procs
        used_window, candidates = ctx.memo(
            ("tofa-ml-candidates", n), lambda: cls._candidates_lazy(ctx))
        placements = np.stack([
            multilevel.multilevel_map(ctx.G_w, nodes, ctx.coords, D=W,
                                      rng=ctx.rng,
                                      coarse_target=cls.COARSE_TARGET)
            for nodes in candidates])
        scores = mapping.hop_bytes_batch(ctx.G_w, W, placements)
        return PolicyOutput(placements[int(np.argmin(scores))],
                            used_consecutive_window=used_window)

    @staticmethod
    def _candidates_lazy(ctx: PolicyContext) -> tuple[bool, list[np.ndarray]]:
        """O(N)-memory candidate node sets: the first consecutive-healthy
        window plus a hierarchical (rack-first) compact ball."""
        n = ctx.n_procs
        p_f = ctx.p_f
        W = ctx.weights
        N = W.shape[0]
        S = find_consecutive_healthy(p_f, n)
        candidates: list[np.ndarray] = []
        if S is not None:
            candidates.append(S)
            # further healthy windows — the scan is O(N), and window
            # diversity is what closes the quality gap to the dense
            # candidate search under sparse faults
            for s0 in _healthy_window_starts(p_f, n)[1:4]:
                candidates.append(np.arange(s0, s0 + n))
        topo = getattr(ctx.request, "topology", None)
        if hasattr(topo, "hierarchy_groups"):
            groups = topo.hierarchy_groups(max(64, N // 256))
            healthy = p_f == 0
            hmask = healthy if healthy.sum() >= n else None
            ball = multilevel.hierarchical_select(W, groups, n, healthy=hmask)
            if len(ball) >= n:
                candidates.append(ball)
            faulty = np.flatnonzero(p_f > 0)
            if faulty.size and hmask is not None:
                # a second ball grown from the rack farthest from any
                # fault — the lazy analogue of the dense path's
                # far-seeded select_nodes candidates.  Rep-to-fault
                # distances touch #groups x #faults entries only.
                ng = int(groups.max()) + 1
                first = np.full(ng, -1, dtype=np.int64)
                hid = np.flatnonzero(healthy)
                first[groups[hid[::-1]]] = hid[::-1]
                live = np.flatnonzero(first >= 0)
                reps = first[live]
                dist_to_fault = np.asarray(
                    W[reps[:, None], faulty[None, :]], np.float64).min(axis=1)
                far_group = int(live[np.argmax(dist_to_fault)])
                ball2 = multilevel.hierarchical_select(
                    W, groups, n, healthy=hmask, seed_group=far_group)
                if len(ball2) >= n:
                    candidates.append(ball2)
        if not candidates:
            # last resort: lazy-aware frontier growth (blocked seed scan)
            candidates.append(mapping.select_nodes(W, n))
        return S is not None, candidates
