"""PlacementEngine — the unified placement service.

One typed entry point replaces the old per-call-site wiring: a frozen
:class:`PlacementRequest` (comm graph, topology, a versioned
:class:`~repro_torch.core.state.ClusterState` health snapshot, stragglers,
metric, seed) goes in and a :class:`PlacementPlan` (placement array,
policy provenance, hop-bytes / dilation cost breakdown, faulty-node
exposure, wall-time) comes out.

Policies are classes registered in :mod:`repro_torch.core.policies`; hosts are
anything satisfying the :class:`Topology` protocol (``TorusTopology``,
``FatTreeTopology``, ...).  The engine caches hop and Eq. 1
weight matrices per ``(topology, state key)`` — the state key is the
snapshot's monotonic *epoch* (plus an overlay digest for derived views),
so schedulers and batch simulators that place thousands of jobs against
a slowly-drifting health feed hit warm caches until health actually
changes, with no byte-hashing or quantization of the raw vectors.  When
a health change does arrive, topologies that implement
``weight_matrix_update`` get a *row-wise delta refresh*: only the matrix
entries whose routes touch a changed node are recomputed (bit-identical
to a full derivation, differentially tested).

:meth:`PlacementEngine.replace` performs incremental re-placement when a
state diff (or an explicit failed set) invalidates a running plan, with
a fast path that skips work entirely when the diff does not touch the
incumbent placement.  The legacy ``(p_f, available)`` kwargs remain as a
deprecation shim that interns an equivalent ``ClusterState`` internally.

The engine runs its placements on the torch backend on ``cuda`` unless
told otherwise (``backend="numpy"``, or ``device="cpu"`` for the plain
PyTorch kernels); with no GPU visible the default raises instead of
running on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import OrderedDict
from typing import (Any, Iterable, Optional, Protocol, Sequence, Union,
                    runtime_checkable)

import numpy as np

from . import backend as _backend
from .comm_graph import CommGraph
from .lazydist import is_lazy
from .mapping import avg_dilation, hop_bytes
from .policies import PolicyContext, available_policies, get_policy
from .state import ClusterState, StateDiff

# free-row block budget of the lazy-exact replace cost: at most this many
# implicit W entries are materialised at a time (~32 MB of float64)
_REPLACE_BLOCK_ELEMS = 1 << 22


def _lazy_replace_cost(W, G_w: np.ndarray, i: int, peers: np.ndarray,
                       placement: np.ndarray, free: np.ndarray) -> np.ndarray:
    """Traffic-weighted cost of every free node for displaced proc ``i``
    against a :class:`~repro_torch.core.lazydist.LazyDistance` ``W`` — O(block)
    memory instead of the dense gather's O(|free| * |peers|).

    Exactness: zero-weight peers are dropped before the gather (their
    products contribute exactly 0.0 — in-tree weights are integers, so
    every partial sum is exact in float64), and the blocking is over free
    *rows* only, so each cost entry is still one full-row reduction —
    bit-identical to the unblocked dense expression.
    """
    if peers.size:
        gw = G_w[i, peers]
        nz = gw != 0.0
        peers, gw = peers[nz], gw[nz]
    cost = np.empty(free.size, dtype=np.float64)
    if peers.size:
        cols = placement[peers]
        step = max(1, _REPLACE_BLOCK_ELEMS // max(1, cols.size))
        for s in range(0, free.size, step):
            blk = free[s:s + step]
            cost[s:s + step] = W[np.ix_(blk, cols)] @ gw
    else:
        # isolated proc: most central node (full row sums)
        step = max(1, _REPLACE_BLOCK_ELEMS // max(1, W.shape[0]))
        for s in range(0, free.size, step):
            blk = free[s:s + step]
            cost[s:s + step] = W[blk].sum(axis=1)
    return cost


@runtime_checkable
class Topology(Protocol):
    """Host-fabric protocol: anything exposing these can be placed onto.

    Implementations in-tree: :class:`~repro_torch.core.topology.TorusTopology`
    (d-dim torus with dimension-ordered routing) and
    :class:`~repro_torch.core.fattree.FatTreeTopology` (k-ary Clos).
    Topologies may additionally implement
    ``weight_matrix_update(W_prev, changed, p_f, straggler=...)`` to
    refresh only the entries a small health delta invalidates.
    """

    @property
    def n_nodes(self) -> int: ...

    def coords_array(self) -> np.ndarray: ...

    def hop_matrix(self) -> np.ndarray: ...

    def weight_matrix(self, p_f: Optional[np.ndarray] = None,
                      straggler: Optional[np.ndarray] = None) -> np.ndarray: ...


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementRequest:
    """Everything a placement decision depends on, validated up front.

    Health and availability travel as one versioned ``state``
    (:class:`~repro_torch.core.state.ClusterState`): allocatable nodes (UP or
    DEGRADED, minus any overlay mask) restrict every policy — Slurm never
    schedules onto DOWN/DRAINED nodes, independent of fault-awareness —
    and the state's pinned outage vector feeds Eq. 1.

    The pre-state ``(p_f, available)`` kwargs are kept one release as a
    deprecation shim: passing them (without ``state``) interns an
    equivalent ``ClusterState`` by content, so legacy callers that
    re-submit identical health vectors keep the same epoch and hence
    warm engine caches.  ``available`` order is preserved on the shim
    path — ``linear`` consumes it sequentially.
    """

    comm: CommGraph
    topology: Topology
    state: Optional[ClusterState] = None      # versioned health snapshot
    p_f: Optional[np.ndarray] = None          # deprecated: outage kwarg
    straggler: Optional[np.ndarray] = None    # per-node slowdown factor
    available: Optional[np.ndarray] = None    # deprecated: allocatable ids
    metric: str = "volume"                    # guest edge weight: volume|messages
    seed: int = 0                             # default RNG seed

    def __post_init__(self):
        n, N = self.comm.n, self.topology.n_nodes
        if self.metric not in ("volume", "messages"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.straggler is not None:
            v = np.asarray(self.straggler, dtype=np.float64)
            if v.shape != (N,):
                raise ValueError(
                    f"straggler has shape {v.shape}, topology has {N} nodes")
            object.__setattr__(self, "straggler", v)
        if self.state is not None:
            if self.p_f is not None or self.available is not None:
                raise ValueError(
                    "pass either state= or the legacy (p_f, available) "
                    "kwargs, not both")
            if self.state.n_nodes != N:
                raise ValueError(
                    f"state has {self.state.n_nodes} nodes, topology {N}")
            object.__setattr__(self, "_explicit_available", False)
            # legacy-field views so policies and diagnostics keep working:
            # p_f is the *pinned* outage vector (non-allocatable == 1.0)
            object.__setattr__(self, "p_f", self.state.outage_vector())
            object.__setattr__(self, "available",
                               self.state.available_ids())
        else:
            if self.p_f is not None:
                v = np.asarray(self.p_f, dtype=np.float64)
                if v.shape != (N,):
                    raise ValueError(
                        f"p_f has shape {v.shape}, topology has {N} nodes")
                object.__setattr__(self, "p_f", v)
            if self.available is not None:
                a = np.asarray(self.available, dtype=np.int64)
                if a.ndim != 1:
                    raise ValueError(
                        "available must be a 1-d array of node ids")
                if a.size and (a.min() < 0 or a.max() >= N):
                    raise ValueError(
                        f"available ids out of range [0, {N}) for this "
                        f"topology")
                object.__setattr__(self, "available", a)
            object.__setattr__(self, "_explicit_available",
                               self.available is not None)
            # deprecation shim: intern an equivalent state by content so
            # identical legacy kwargs share one epoch (and warm caches)
            object.__setattr__(self, "state", ClusterState.from_arrays(
                N, p_f=self.p_f, available=self.available))
        if n > N:
            raise ValueError(f"{n} processes > {N} nodes")
        if len(self.available_ids) < n:
            raise ValueError(
                f"{n} processes > {len(self.available_ids)} available nodes")

    # ---------------------------------------------------------------- views
    @property
    def n_procs(self) -> int:
        return self.comm.n

    @property
    def n_nodes(self) -> int:
        return self.topology.n_nodes

    @property
    def available_ids(self) -> np.ndarray:
        if self.available is None:
            return np.arange(self.n_nodes)
        return self.available

    @property
    def health_key(self) -> tuple:
        """Cache token for everything derived from this request's health:
        the state key (epoch + overlay digest) plus the straggler bytes."""
        s = None if self.straggler is None else self.straggler.tobytes()
        return (self.state.key, s)

    @property
    def route_health_key(self) -> tuple:
        """Cache token for route-weight derivations: like
        :attr:`health_key` but ignoring busy-flavored overlay masks
        (``state.route_key``) — busy nodes are valid routers, so requests
        that differ only in who holds a lease share one weight matrix."""
        s = None if self.straggler is None else self.straggler.tobytes()
        return (self.state.route_key, s)

    def route_p_f(self) -> np.ndarray:
        """Outage vector as the Eq. 1 weight derivation sees it: failed /
        drained / down pinned to 1.0, busy-flavored overlay nodes kept at
        their base belief (identical to :meth:`effective_p_f` for every
        request without a busy-flavored overlay)."""
        return self.state.route_outage_vector()

    def effective_p_f(self) -> np.ndarray:
        """Outage vector as the mapper sees it: unavailable nodes are
        certain outages (pinned to 1.0) regardless of the heartbeat view."""
        p = (np.zeros(self.n_nodes) if self.p_f is None
             else self.p_f.copy())
        if self.available is not None:
            mask = np.ones(self.n_nodes, dtype=bool)
            mask[self.available] = False
            p[mask] = 1.0
        return p

    def restrict(self, busy, *, route_faulty: bool = True
                 ) -> "PlacementRequest":
        """This request minus ``busy`` nodes (exclusive-allocation
        threading).  State-built requests get a cheap overlay — fault
        flavored by default, busy flavored (weight caches keep keying on
        the base health) with ``route_faulty=False``; shim requests keep
        their verbatim availability order."""
        busy = np.atleast_1d(np.asarray(busy, dtype=np.int64))
        if not busy.size:
            return self
        if getattr(self, "_explicit_available", False):
            avail = self.available
            return PlacementRequest(
                comm=self.comm, topology=self.topology,
                p_f=None if self.p_f is None else self.p_f,
                straggler=self.straggler,
                available=avail[~np.isin(avail, busy)],
                metric=self.metric, seed=self.seed)
        return PlacementRequest(
            comm=self.comm, topology=self.topology,
            state=self.state.overlay(unavailable=busy,
                                     route_faulty=route_faulty),
            straggler=self.straggler, metric=self.metric, seed=self.seed)


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementPlan:
    """T = <process id, node id> plus provenance and cost diagnostics."""

    placement: np.ndarray           # (n_procs,) node ids
    policy: str                     # registry name that produced this plan
    request: PlacementRequest       # the request it answers
    hop_bytes: float                # dilation-volume under healthy hop metric
    avg_dilation: float             # traffic-weighted mean hop distance
    hop_bytes_fault_weighted: Optional[float]  # under Eq. 1 weights, if computed
    faulty_nodes_used: int          # processes placed on p_f > 0 nodes
    used_consecutive_window: bool   # TOFA step 10 succeeded?
    wall_time_s: float              # mapper wall-clock for this plan
    provenance: str = "place"       # place | replace-incremental | replace-full

    @property
    def n_procs(self) -> int:
        return len(self.placement)

    def as_pairs(self) -> list[tuple[int, int]]:
        return [(i, int(nid)) for i, nid in enumerate(self.placement)]

    def cost_breakdown(self) -> dict:
        """Quality report: hop-bytes, dilation, fault exposure, wall time."""
        return {
            "hop_bytes": self.hop_bytes,
            "avg_dilation": self.avg_dilation,
            "hop_bytes_fault_weighted": self.hop_bytes_fault_weighted,
            "faulty_nodes_used": self.faulty_nodes_used,
            "wall_time_s": self.wall_time_s,
        }

    def to_result(self):
        """Legacy :class:`~repro_torch.core.tofa.PlacementResult` view
        (shim)."""
        from .tofa import PlacementResult
        return PlacementResult(
            placement=self.placement,
            policy=self.policy,
            used_consecutive_window=self.used_consecutive_window,
            hop_bytes=self.hop_bytes,
            faulty_nodes_used=self.faulty_nodes_used,
        )


class PlacementEngine:
    """Policy-pluggable, cache-backed placement service.

    Hop matrices are cached per topology; Eq. 1 weight matrices and
    policy memo dicts per ``(topology, health key)`` with LRU eviction.
    The health key is the request state's epoch (plus overlay digest), so
    cache lifetime tracks *actual* health changes: a thousand placements
    against one epoch derive the weight matrix once, and on the torch
    backend the same matrix object stays device-resident across all of
    them (the backend's identity-keyed transfer cache composes with the
    epoch keying — one epoch, one host->device transfer).
    """

    def __init__(self, default_policy: str = "tofa",
                 max_cached_weights: int = 16,
                 backend: Optional[str] = "torch",
                 lazy_threshold: Optional[int] = None,
                 max_cached_topologies: int = 32,
                 device: Optional[str] = None):
        """``backend`` pins this engine's placements to an array backend
        (``"torch"`` | ``"numpy"``, see :mod:`repro_torch.core.backend`):
        every ``place``/``place_many``/``replace`` call runs inside
        ``backend.use(...)``.  The default is the torch backend (float64)
        on ``device="cuda"``; it is resolved here, so an engine asked for
        a GPU that is not there raises
        :class:`~repro_torch.core.backend.BackendUnavailableError` at
        construction.  ``device="cpu"`` runs the plain PyTorch kernels.
        ``None`` follows the process-wide active backend (e.g. a float32
        one set with ``backend.use("torch", dtype="float32")``), which is
        the torch backend on ``cuda`` when nothing chose another.

        ``lazy_threshold``: topologies with more nodes than this serve
        hop/weight metrics as O(N)-memory
        :class:`~repro_torch.core.lazydist.LazyDistance` adapters instead of
        dense (N, N) matrices (policies go through the multilevel /
        hierarchical path).  ``None`` reads ``REPRO_LAZY_THRESHOLD``
        (default 4096); pass ``0`` to force lazy everywhere or a huge
        value to force dense.

        ``max_cached_topologies`` bounds the per-topology caches (hop
        metrics, coordinates, delta-refresh bases) with LRU eviction —
        long-lived service processes under topology churn stop growing
        without bound; evictions are counted in :meth:`stats`."""
        self.default_policy = default_policy
        if backend is None:
            if device is not None:
                raise ValueError("device= needs an explicit backend")
            self.backend = None
        else:
            self.backend = _backend.get_backend(backend, device=device)
        if lazy_threshold is None:
            lazy_threshold = int(os.environ.get("REPRO_LAZY_THRESHOLD",
                                                "4096"))
        self.lazy_threshold = lazy_threshold
        self._hops: OrderedDict[Any, np.ndarray] = OrderedDict()
        self._coords: OrderedDict[Any, np.ndarray] = OrderedDict()
        self._weights: OrderedDict[Any, np.ndarray] = OrderedDict()
        self._shared: OrderedDict[Any, dict] = OrderedDict()
        # per-topology record of the last derived weight matrix and the
        # health it answers — the base for row-wise delta refreshes
        self._weights_last: OrderedDict[Any, tuple] = OrderedDict()
        self._pinned: OrderedDict[int, Topology] = OrderedDict()
        self._max_weights = max_cached_weights
        self._max_topos = max_cached_topologies
        self.stats = {"hop_hits": 0, "hop_misses": 0,
                      "weight_hits": 0, "weight_misses": 0,
                      "shared_hits": 0, "shared_misses": 0,
                      "weight_delta_updates": 0,
                      "replace_skips": 0,
                      "topology_evictions": 0,
                      "weight_evictions": 0,
                      "shared_evictions": 0}

    def _lru_touch(self, cache: OrderedDict, key, build, cap: int,
                   evict_stat: str):
        """Fetch-or-build with LRU recency + bounded eviction."""
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        out = cache[key] = build()
        while len(cache) > cap:
            cache.popitem(last=False)
            self.stats[evict_stat] += 1
        return out

    # ------------------------------------------------------------ caching
    def _topo_key(self, topo: Topology):
        try:
            hash(topo)
            return topo       # dict resolves hash collisions via __eq__
        except TypeError:     # unhashable adapter: identity, pinned alive
            self._pinned[id(topo)] = topo
            while len(self._pinned) > self._max_topos:
                self._pinned.popitem(last=False)
            return ("id", id(topo))

    def _use_lazy(self, topo: Topology) -> bool:
        """Whether this topology's metrics are served implicitly (O(N)
        adapters) instead of as dense (N, N) matrices."""
        return (topo.n_nodes > self.lazy_threshold
                and hasattr(topo, "lazy_distance"))

    def hops(self, topo: Topology):
        key = self._topo_key(topo)
        if key in self._hops:
            self.stats["hop_hits"] += 1
        else:
            self.stats["hop_misses"] += 1
        build = (topo.lazy_distance if self._use_lazy(topo)
                 else topo.hop_matrix)
        return self._lru_touch(self._hops, key, build, self._max_topos,
                               "topology_evictions")

    def coords(self, topo: Topology) -> np.ndarray:
        key = self._topo_key(topo)
        return self._lru_touch(self._coords, key, topo.coords_array,
                               self._max_topos, "topology_evictions")

    def weights(self, topo: Topology, p_f: Optional[np.ndarray] = None,
                straggler: Optional[np.ndarray] = None) -> np.ndarray:
        """Eq. 1 route-weight matrix for one (topology, health) state.

        Direct-array entry point (legacy: keys on the raw bytes).
        Engine-internal placements go through :meth:`_weights_for`, which
        keys on the request state's epoch instead."""
        key = (self._topo_key(topo),
               None if p_f is None else np.asarray(p_f).tobytes(),
               None if straggler is None else np.asarray(straggler).tobytes())
        return self._weights_cached(topo, key, p_f, straggler)

    def _weights_for(self, topo: Topology,
                     request: PlacementRequest,
                     p_f_route: np.ndarray) -> np.ndarray:
        """Weight matrix for a request, epoch-keyed on its health state.

        Keys on the *route* health key: requests that differ only in a
        busy-flavored overlay (the service's lease churn) share one
        matrix per health epoch.  ``p_f_route`` must be the matching
        :meth:`PlacementRequest.route_p_f` vector."""
        key = (self._topo_key(topo),) + request.route_health_key
        return self._weights_cached(topo, key, p_f_route, request.straggler)

    def _weights_cached(self, topo: Topology, key,
                        p_f: Optional[np.ndarray],
                        straggler: Optional[np.ndarray]) -> np.ndarray:
        no_fault = p_f is None or not (np.asarray(p_f) > 0).any()
        no_slow = straggler is None or not (np.asarray(straggler) > 0).any()
        if no_fault and no_slow:
            # Eq. 1 with all-healthy nodes degenerates to the hop metric
            return self.hops(topo)
        if key in self._weights:
            self.stats["weight_hits"] += 1
            self._weights.move_to_end(key)
            return self._weights[key]
        self.stats["weight_misses"] += 1
        w = self._derive_weights(topo, p_f, straggler)
        self._weights[key] = w
        while len(self._weights) > self._max_weights:
            self._weights.popitem(last=False)
            self.stats["weight_evictions"] += 1
        return w

    def _derive_weights(self, topo: Topology,
                        p_f: Optional[np.ndarray],
                        straggler: Optional[np.ndarray]) -> np.ndarray:
        """Full derivation, or a row-wise delta refresh from the last
        derived matrix when the topology supports it and the health delta
        is small.  Delta results are bit-identical to full derivation
        (only entries whose routes touch a changed node can differ, and
        exactly those are recomputed with the same formula)."""
        if self._use_lazy(topo):
            # implicit regime: the adapter IS the weight matrix — O(N)
            # per (topology, state) entry, no delta machinery needed
            # (entries are computed per access, so there is no stored
            # base to refresh)
            return topo.lazy_distance(p_f, straggler=straggler)
        n = topo.n_nodes
        flags = (np.zeros(n, dtype=bool) if p_f is None
                 else np.asarray(p_f) > 0)
        slow = None
        if straggler is not None and (np.asarray(straggler) > 0).any():
            slow = np.asarray(straggler, dtype=np.float64)
        topo_key = self._topo_key(topo)
        last = self._weights_last.get(topo_key)
        W = None
        if last is not None and hasattr(topo, "weight_matrix_update"):
            prev_flags, prev_slow, W_prev = last
            changed = flags != prev_flags
            if slow is not None or prev_slow is not None:
                sl = slow if slow is not None else np.zeros(n)
                psl = prev_slow if prev_slow is not None else np.zeros(n)
                changed = changed | (sl != psl)
            n_changed = int(changed.sum())
            if n_changed == 0:
                W = W_prev
            elif n_changed <= max(1, n // 4):
                W = topo.weight_matrix_update(
                    W_prev, np.flatnonzero(changed), p_f,
                    straggler=straggler)
                self.stats["weight_delta_updates"] += 1
        if W is None:
            W = topo.weight_matrix(p_f, straggler=straggler)
        self._weights_last[topo_key] = (flags, slow, W)
        self._weights_last.move_to_end(topo_key)
        while len(self._weights_last) > self._max_topos:
            self._weights_last.popitem(last=False)
            self.stats["topology_evictions"] += 1
        return W

    def shared_cache(self, topo: Topology,
                     p_f: Optional[np.ndarray] = None,
                     straggler: Optional[np.ndarray] = None) -> dict:
        """Policy memo dict for one (topology, health) state (raw-array
        entry point; engine-internal placements key on the state epoch).

        Policies use it (via :meth:`PolicyContext.memo`) for
        guest-independent intermediates — e.g. TOFA's consecutive-window
        and compact-ball candidate node sets, which depend only on the
        health snapshot and job size, not on the traffic matrix — so batch
        runs placing many jobs against the same snapshot derive them once.
        """
        key = (self._topo_key(topo),
               None if p_f is None else np.asarray(p_f).tobytes(),
               None if straggler is None else np.asarray(straggler).tobytes())
        return self._shared_cached(key)

    def _shared_for(self, topo: Topology, request: PlacementRequest) -> dict:
        # scoped per route health key (one dict per epoch under lease
        # churn); availability-dependent entries are disambiguated inside
        # the dict by PolicyContext.avail_token
        return self._shared_cached(
            (self._topo_key(topo),) + request.route_health_key)

    def _shared_cached(self, key) -> dict:
        if key in self._shared:
            self.stats["shared_hits"] += 1
            self._shared.move_to_end(key)
            return self._shared[key]
        self.stats["shared_misses"] += 1
        d: dict = {}
        self._shared[key] = d
        while len(self._shared) > self._max_weights:
            self._shared.popitem(last=False)
            self.stats["shared_evictions"] += 1
        return d

    def cache_stats(self) -> dict:
        return dict(self.stats,
                    cached_topologies=len(self._hops),
                    cached_weight_matrices=len(self._weights),
                    cached_shared_dicts=len(self._shared))

    def cache_hit_rate(self) -> float:
        """Fraction of weight + shared lookups served warm (1.0 when no
        lookups happened yet) — the number the epoch-keyed state model
        keeps high under heartbeat jitter (see benchmarks/state_churn.py)."""
        hits = self.stats["weight_hits"] + self.stats["shared_hits"]
        misses = self.stats["weight_misses"] + self.stats["shared_misses"]
        total = hits + misses
        return 1.0 if total == 0 else hits / total

    def _backend_ctx(self):
        return (_backend.use(self.backend) if self.backend is not None
                else contextlib.nullcontext())

    # ----------------------------------------------------------- placement
    def place(self, request: PlacementRequest, policy: Optional[str] = None,
              *, rng: Optional[np.random.Generator] = None) -> PlacementPlan:
        """Run one registered policy against one request."""
        with self._backend_ctx():
            return self._place(request, policy, rng=rng)

    def _place(self, request: PlacementRequest, policy: Optional[str] = None,
               *, rng: Optional[np.random.Generator] = None) -> PlacementPlan:
        name = policy or self.default_policy
        pol = get_policy(name)
        rng = rng if rng is not None else np.random.default_rng(request.seed)
        t0 = time.perf_counter()
        topo = request.topology
        p_f = request.effective_p_f()
        route_p = request.route_p_f()
        ctx = PolicyContext(
            request=request,
            G_w=request.comm.weights(request.metric),
            coords=self.coords(topo),
            hops=self.hops(topo),
            p_f=p_f,
            available=request.available_ids,
            rng=rng,
            _weights_fn=lambda: self._weights_for(topo, request, route_p),
            shared=self._shared_for(topo, request),
            avail_token=request.state.key,
        )
        out = pol.place(ctx)
        wall = time.perf_counter() - t0
        return self._plan(request, name, np.asarray(out.placement),
                          out.used_consecutive_window, ctx, wall, "place")

    def compare(self, request: PlacementRequest,
                policies: Optional[Iterable[str]] = None,
                ) -> dict[str, PlacementPlan]:
        """One plan per policy (fresh seeded RNG each) — the quality report."""
        out = {}
        for pol in (tuple(policies) if policies is not None
                    else available_policies()):
            rng = np.random.default_rng(request.seed)
            out[pol] = self.place(request, policy=pol, rng=rng)
        return out

    def place_many(self, requests: Sequence[PlacementRequest],
                   policy: Union[str, Sequence[str], None] = None,
                   *, rng: Optional[np.random.Generator] = None,
                   exclusive: bool = False,
                   route_faulty: bool = True) -> list[PlacementPlan]:
        """Batched placement: one plan per request, in request order.

        Produces exactly the plans the equivalent sequence of
        :meth:`place` calls would (differentially tested in
        ``tests/test_backend_diff.py``) while paying batch costs once:
        the whole batch runs inside one backend scope, so per-(topology,
        health) hop/weight matrices, the policies' shared candidate
        memos, and — on the torch backend — the device-resident distance
        matrices and compiled kernels are derived or transferred a single
        time and reused by every job in the batch.

        ``policy`` is one name for the whole batch (default:
        ``default_policy``) or one name per request (the scheduler maps
        each job's ``srun --distribution`` here).  ``rng`` is threaded
        through the batch in order; ``None`` gives every request its own
        ``default_rng(request.seed)``, matching ``place``.

        ``exclusive=True`` applies scheduler queue-drain semantics:
        requests are placed in order and each is restricted — via a
        cheap :meth:`ClusterState.overlay` when the request carries a
        state — to nodes no earlier plan in the batch occupies (Slurm's
        exclusive node allocation).  Raises ``ValueError`` — like the
        equivalent sequential validation would — if a request no longer
        fits in what remains.  ``route_faulty`` picks the overlay flavor
        the intra-batch restriction uses: the default treats occupied
        nodes as certain outages (historical behavior); the placement
        service passes ``False`` so occupied nodes stay valid routers and
        the whole drain tick shares epoch-keyed weight matrices.
        """
        requests = list(requests)
        if policy is None or isinstance(policy, str):
            policies = [policy] * len(requests)
        else:
            policies = list(policy)
            if len(policies) != len(requests):
                raise ValueError(
                    f"{len(policies)} policies for {len(requests)} requests")
        plans: list[PlacementPlan] = []
        taken: dict[Any, np.ndarray] = {}   # topo key -> occupied node ids
        with self._backend_ctx():
            for req, pol in zip(requests, policies):
                key = self._topo_key(req.topology)
                if exclusive:
                    busy = taken.get(key)
                    if busy is not None and busy.size:
                        req = req.restrict(busy, route_faulty=route_faulty)
                plan = self._place(req, policy=pol, rng=rng)
                plans.append(plan)
                if exclusive:
                    prev = taken.get(key)
                    ids = np.asarray(plan.placement, dtype=np.int64)
                    taken[key] = (ids if prev is None
                                  else np.concatenate([prev, ids]))
        return plans

    # -------------------------------------------------------- re-placement
    def replace(self, plan: PlacementPlan,
                failed_nodes: Union[Sequence[int], np.ndarray, None] = None,
                *, state: Optional[ClusterState] = None,
                rng: Optional[np.random.Generator] = None,
                full: bool = False,
                p_f: Optional[np.ndarray] = None,
                available: Optional[np.ndarray] = None) -> PlacementPlan:
        """Incremental fault-driven (or diff-driven) re-placement.

        Marks ``failed_nodes`` as certain outages (an overlay on the
        health state), and moves only the displaced processes — each to
        the free surviving node minimising its traffic-weighted Eq. 1
        cost against the processes that stay put.  Falls back to a full
        re-map (``provenance="replace-full"``) when ``full=True`` or more
        than half the job is displaced.  Raises ``ValueError`` when the
        survivors cannot hold the job.

        ``state`` refreshes the health view to the caller's *current*
        snapshot — the plan's request carries the submit-time snapshot,
        stale once other nodes fail or drain after submission.  With
        ``state`` given and ``failed_nodes`` omitted, the failed set is
        computed from the **state diff**: the nodes that were allocatable
        at submit time but are not any more.  **Fast path:** when the
        diff (or the explicit failed set) does not touch any node the
        incumbent placement uses, the plan is returned unchanged — no
        matrices, no context, no new request.

        The legacy ``p_f=`` / ``available=`` kwargs remain as a
        deprecation shim equivalent to passing the interned state they
        describe.
        """
        with self._backend_ctx():
            return self._replace(plan, failed_nodes, state=state, rng=rng,
                                 full=full, p_f=p_f, available=available)

    def _replace(self, plan: PlacementPlan,
                 failed_nodes: Union[Sequence[int], np.ndarray, None] = None,
                 *, state: Optional[ClusterState] = None,
                 rng: Optional[np.random.Generator] = None,
                 full: bool = False,
                 p_f: Optional[np.ndarray] = None,
                 available: Optional[np.ndarray] = None) -> PlacementPlan:
        req = plan.request
        if state is not None and (p_f is not None or available is not None):
            raise ValueError("pass either state= or the legacy "
                             "(p_f, available) kwargs, not both")
        if state is not None:
            base = state
        elif p_f is not None or available is not None:
            base = ClusterState.from_arrays(
                req.n_nodes,
                p_f=req.p_f if p_f is None else np.asarray(p_f, np.float64),
                available=(req.available_ids if available is None
                           else np.asarray(available, dtype=np.int64)))
        else:
            base = req.state
        if failed_nodes is None:
            diff = req.state.diff(base)
            failed = diff.lost()
        else:
            failed = np.unique(np.atleast_1d(
                np.asarray(failed_nodes, dtype=np.int64)))
            if failed.size and (failed.min() < 0
                                or failed.max() >= req.n_nodes):
                raise ValueError(
                    f"failed node ids out of range [0, {req.n_nodes})")

        placement = plan.placement.copy()
        displaced = np.flatnonzero(np.isin(placement, failed))
        if not full and len(displaced) == 0:
            # the change does not touch this job: keep the plan as-is
            self.stats["replace_skips"] += 1
            return plan

        if state is None and (available is not None
                              or getattr(req, "_explicit_available", False)):
            # legacy shim with an explicitly-*ordered* availability array:
            # preserve the caller's order verbatim (``linear`` consumes it
            # sequentially), exactly as the pre-state API did
            base_p_f = (req.p_f if p_f is None
                        else np.asarray(p_f, np.float64))
            new_p_f = (np.zeros(req.n_nodes) if base_p_f is None
                       else base_p_f.copy())
            new_p_f[failed] = 1.0
            avail = (req.available_ids if available is None
                     else np.asarray(available, dtype=np.int64))
            new_avail = avail[~np.isin(avail, failed)]
            if len(new_avail) < req.n_procs:
                raise ValueError(
                    f"cannot re-place: {req.n_procs} processes > "
                    f"{len(new_avail)} surviving nodes")
            new_req = PlacementRequest(
                comm=req.comm, topology=req.topology, p_f=new_p_f,
                available=new_avail, straggler=req.straggler,
                metric=req.metric, seed=req.seed)
        else:
            new_state = base.overlay(unavailable=failed)
            new_avail = new_state.available_ids()
            if len(new_avail) < req.n_procs:
                raise ValueError(
                    f"cannot re-place: {req.n_procs} processes > "
                    f"{len(new_avail)} surviving nodes")
            new_req = PlacementRequest(
                comm=req.comm, topology=req.topology, state=new_state,
                straggler=req.straggler, metric=req.metric, seed=req.seed)

        if full or len(displaced) > max(1, len(placement) // 2):
            fresh = self._place(new_req, policy=plan.policy, rng=rng)
            return dataclasses.replace(fresh, provenance="replace-full")

        t0 = time.perf_counter()
        p_eff = new_req.effective_p_f()
        ctx = PolicyContext(
            request=new_req,
            G_w=req.comm.weights(req.metric),
            coords=self.coords(req.topology),
            hops=self.hops(req.topology),
            p_f=p_eff,
            available=new_avail,
            rng=rng if rng is not None else np.random.default_rng(req.seed),
            avail_token=new_req.state.key,
        )
        W = self._weights_for(req.topology, new_req, new_req.route_p_f())
        ctx._weights = W
        used = np.zeros(req.n_nodes, dtype=bool)
        kept = np.ones(len(placement), dtype=bool)
        kept[displaced] = False
        used[placement[kept]] = True
        free = new_avail[~used[new_avail]]
        # heaviest talkers first: they constrain the remaining choices most
        order = displaced[np.argsort(ctx.G_w[displaced].sum(axis=1))[::-1]]
        settled = kept.copy()
        lazy_W = is_lazy(W)
        for i in order:
            peers = np.flatnonzero(settled)
            if lazy_W:
                cost = _lazy_replace_cost(W, ctx.G_w, int(i), peers,
                                          placement, free)
            elif peers.size:
                cost = W[np.ix_(free, placement[peers])] @ ctx.G_w[i, peers]
            else:
                cost = W[free].sum(axis=1)  # isolated: most central node
            best = free[int(np.argmin(cost))]
            placement[i] = best
            settled[i] = True
            free = free[free != best]
        wall = time.perf_counter() - t0
        return self._plan(new_req, plan.policy, placement,
                          plan.used_consecutive_window, ctx, wall,
                          "replace-incremental")

    # ------------------------------------------------------------ internals
    def _plan(self, request, policy, placement, used_window, ctx, wall,
              provenance) -> PlacementPlan:
        weighted = (hop_bytes(ctx.G_w, ctx.weights, placement)
                    if ctx.weights_computed else None)
        return PlacementPlan(
            placement=placement,
            policy=policy,
            request=request,
            hop_bytes=hop_bytes(ctx.G_w, ctx.hops, placement),
            avg_dilation=avg_dilation(ctx.G_w, ctx.hops, placement),
            hop_bytes_fault_weighted=weighted,
            faulty_nodes_used=int((ctx.p_f[placement] > 0).sum()),
            used_consecutive_window=used_window,
            wall_time_s=wall,
            provenance=provenance,
        )


# one shared engine per requested device (None: the default, ``cuda``)
_DEFAULT_ENGINES: dict = {}


def default_engine(device: Optional[str] = None) -> PlacementEngine:
    """Process-wide shared engine on ``device`` (used by the legacy shims
    so repeated ``place()`` calls still benefit from matrix caching).
    ``device=None`` means ``cuda``: without a GPU it raises
    :class:`~repro_torch.core.backend.BackendUnavailableError`."""
    eng = _DEFAULT_ENGINES.get(device)
    if eng is None:
        eng = _DEFAULT_ENGINES[device] = PlacementEngine(device=device)
    return eng
