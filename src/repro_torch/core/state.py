"""ClusterState — the versioned, immutable health model of the platform.

The paper's placement decisions are functions of *node health*: per-node
outage probabilities feed the Eq. 1 route weights, and availability
restricts every policy.  Before this module, health travelled as loose
``(p_f, available)`` arrays with four independent owners; here it is one
first-class value:

* **Immutable snapshot.**  A :class:`ClusterState` never changes; every
  mutation (:meth:`with_health`, :meth:`with_outage`, :meth:`evolve`)
  returns a *new* state carrying a fresh, process-monotonic **epoch**.
  ``snapshot()`` is the O(1) handle — the object itself.
* **Epoch-keyed caching.**  ``state.key`` is a stable cache token:
  equal keys imply identical health, so the
  :class:`~repro_torch.core.engine.PlacementEngine` keys its hop/weight/memo
  caches on ``(topology, state.key)`` instead of hashing raw float
  vectors — a heartbeat round that does not change health keeps the
  epoch and every warm cache (no more quantization workarounds).
* **Overlays.**  :meth:`overlay` derives a cheap view with extra nodes
  made unallocatable (busy allocations, freshly failed nodes) without
  minting a new epoch: the derived key is ``(base key, digest of the
  masked set)``, so repeated placements against the same base state and
  busy set stay warm.  Overlays come in two flavors: the default
  (``route_faulty=True``) treats masked nodes exactly like certain
  outages — routes through them are penalized by Eq. 1, the right model
  for *failed* nodes — while ``route_faulty=False`` marks nodes merely
  *busy*: excluded from selection, but still perfectly good routers, so
  the route-weight matrix (and its :attr:`route_key` cache token) stays
  that of the base state.  A serving loop whose busy set changes every
  drain tick keeps one weight matrix per health epoch instead of one
  per busy digest (see :mod:`repro.service.service` in the reference package).
* **Diffs.**  :meth:`diff` returns exactly the node ids whose effective
  health changed between two states — what incremental re-placement and
  row-wise weight-matrix updates consume.

Lifecycle is four-valued (:class:`NodeHealth`): ``UP`` and ``DEGRADED``
nodes are *allocatable* (a degraded node serves jobs with an elevated
outage estimate — Eq. 1 steers around it without banning it), while
``DRAINED`` (administrative removal) and ``DOWN`` nodes are not.  The
stored ``p_f`` vector is the scheduler's *belief* for allocatable nodes;
:meth:`outage_vector` pins non-allocatable nodes to 1.0 — the exact
"unavailable nodes are certain outages" convention the engine has always
applied.

Epoch semantics: epochs come from one process-wide monotonic counter, so
``(topology, epoch)`` can never collide across trackers.  Overlays keep
their base's epoch (they are views, not new health observations) and
differ only in ``key``.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np


class NodeHealth(enum.IntEnum):
    """Per-node lifecycle. UP/DEGRADED are allocatable; DRAINED/DOWN are not."""

    UP = 0
    DEGRADED = 1
    DRAINED = 2
    DOWN = 3


_ALLOCATABLE = frozenset((NodeHealth.UP, NodeHealth.DEGRADED))

# process-wide monotonic epoch source: two states with the same epoch are
# the same state, no matter which scheduler / tracker minted them
_EPOCHS = itertools.count(1)


def _ro(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterState:
    """One immutable health snapshot of the whole platform.

    Build with :meth:`healthy` / :meth:`from_arrays`, evolve with
    :meth:`with_health` / :meth:`with_outage` / :meth:`evolve`, derive
    views with :meth:`overlay`.  Never construct directly — the epoch
    and key fields must stay consistent with the content.
    """

    health: np.ndarray                 # (n,) int8 NodeHealth codes
    p_f: np.ndarray                    # (n,) float64 belief, allocatable nodes
    epoch: int                         # monotonic version of the base state
    key: tuple                         # cache token; equal key == equal health
    groups: Optional[tuple[tuple[int, ...], ...]] = None  # rack membership
    masked: Optional[np.ndarray] = None   # overlay-unavailable bool mask
    # busy-flavored overlay mask: unallocatable for *selection* but still a
    # valid router (route weights and route_key come from the base health)
    masked_busy: Optional[np.ndarray] = None

    # ------------------------------------------------------------ factories
    @classmethod
    def healthy(cls, n_nodes: int,
                groups: Optional[Sequence[Sequence[int]]] = None
                ) -> "ClusterState":
        """All nodes UP with zero outage probability."""
        return cls._mint(np.zeros(n_nodes, dtype=np.int8),
                         np.zeros(n_nodes, dtype=np.float64),
                         _freeze_groups(groups))

    @classmethod
    def from_arrays(cls, n_nodes: int,
                    p_f: Optional[np.ndarray] = None,
                    available: Optional[np.ndarray] = None,
                    groups: Optional[Sequence[Sequence[int]]] = None
                    ) -> "ClusterState":
        """State equivalent to the legacy ``(p_f, available)`` kwargs.

        Nodes outside ``available`` are DOWN; everything else is UP with
        the given belief.  Results are *interned* by content: passing the
        same arrays twice returns the same state object (same epoch), so
        legacy callers that re-submit identical health vectors keep warm
        epoch-keyed caches exactly as they kept byte-keyed ones.
        """
        frozen_groups = _freeze_groups(groups)
        key = (int(n_nodes),
               None if p_f is None else np.asarray(p_f, np.float64).tobytes(),
               None if available is None
               else np.asarray(available, np.int64).tobytes(),
               frozen_groups)
        hit = _INTERNED.get(key)
        if hit is not None:
            _INTERNED.move_to_end(key)
            return hit
        health = np.zeros(n_nodes, dtype=np.int8)
        if available is not None:
            down = np.ones(n_nodes, dtype=bool)
            down[np.asarray(available, dtype=np.int64)] = False
            health[down] = int(NodeHealth.DOWN)
        p = (np.zeros(n_nodes, dtype=np.float64) if p_f is None
             else np.asarray(p_f, dtype=np.float64).copy())
        state = cls._mint(health, p, frozen_groups)
        _INTERNED[key] = state
        while len(_INTERNED) > _MAX_INTERNED:
            _INTERNED.popitem(last=False)
        return state

    @classmethod
    def _mint(cls, health: np.ndarray, p_f: np.ndarray,
              groups=None) -> "ClusterState":
        epoch = next(_EPOCHS)
        return cls(health=_ro(health), p_f=_ro(p_f), epoch=epoch,
                   key=("e", epoch), groups=groups)

    # ---------------------------------------------------------------- views
    @property
    def n_nodes(self) -> int:
        return len(self.health)

    @property
    def is_overlay(self) -> bool:
        return self.masked is not None or self.masked_busy is not None

    def snapshot(self) -> "ClusterState":
        """The O(1) immutable handle — the state itself."""
        return self

    def allocatable_mask(self) -> np.ndarray:
        """(n,) bool: nodes placements may use (UP or DEGRADED, unmasked)."""
        m = self.health <= np.int8(NodeHealth.DEGRADED)
        if self.masked is not None:
            m = m & ~self.masked
        if self.masked_busy is not None:
            m = m & ~self.masked_busy
        return m

    def available_ids(self) -> np.ndarray:
        """Allocatable node ids in id (resource-manager) order."""
        return np.flatnonzero(self.allocatable_mask())

    def outage_vector(self) -> np.ndarray:
        """Belief with non-allocatable nodes pinned to certain outage (1.0).

        This is the vector node *selection* consumes: no policy may place
        a process on a busy, drained or down node, so all of them read as
        certain outages here."""
        p = self.p_f.copy()
        p[~self.allocatable_mask()] = 1.0
        return p

    def route_outage_vector(self) -> np.ndarray:
        """Belief as the Eq. 1 *route-weight* derivation consumes it.

        Lifecycle-unallocatable (DRAINED/DOWN) and fault-flavored overlay
        nodes are pinned to 1.0 — routes through them are penalized — but
        busy-flavored overlay nodes keep their base belief: an occupied
        node is a perfectly good router.  Equal :attr:`route_key` implies
        an equal result of this method."""
        p = self.p_f.copy()
        m = self.health <= np.int8(NodeHealth.DEGRADED)
        if self.masked is not None:
            m = m & ~self.masked
        p[~m] = 1.0
        return p

    @property
    def route_key(self) -> tuple:
        """Cache token for route-weight derivations: ignores busy-flavored
        masks, so every drain tick of a serving loop — each with a
        different busy set — shares one weight matrix per health epoch.
        Equals :attr:`key` when no busy mask is present; equals the key of
        the same overlay without its busy mask otherwise."""
        if self.masked_busy is None:
            return self.key          # base state or faulty-only overlay
        base_key = self.key[1]       # ("ob", base_key, f_digest, b_digest)
        if self.masked is None:
            return base_key
        return ("o", base_key, np.flatnonzero(self.masked).tobytes())

    def health_of(self, node_id: int) -> NodeHealth:
        return NodeHealth(int(self.health[node_id]))

    def group_of(self, node_id: int) -> Optional[int]:
        """Index of the rack/group containing ``node_id`` (None if ungrouped)."""
        if self.groups is None:
            return None
        for gi, grp in enumerate(self.groups):
            if node_id in grp:
                return gi
        return None

    # ------------------------------------------------------------ evolution
    def evolve(self, health: Optional[np.ndarray] = None,
               p_f: Optional[np.ndarray] = None,
               atol: Optional[float] = 0.0) -> "ClusterState":
        """New state with the given health codes / belief, *iff* changed.

        Returns ``self`` (same epoch, warm caches) when nothing changed:
        health codes equal, the ``p_f > 0`` pattern equal, and every
        belief delta within ``atol``.  ``atol=None`` means
        *pattern-only*: belief magnitudes never mint an epoch by
        themselves — correct for every Eq. 1-style consumer, which reads
        only the ``p_f > 0`` pattern.  A pattern or lifecycle change
        always mints.  Overlays cannot evolve (evolve the base instead).
        """
        if self.is_overlay:
            raise ValueError("cannot evolve an overlay; evolve its base state")
        new_h = (self.health if health is None
                 else np.asarray(health, dtype=np.int8))
        new_p = (self.p_f if p_f is None
                 else np.asarray(p_f, dtype=np.float64))
        if new_h.shape != self.health.shape or new_p.shape != self.p_f.shape:
            raise ValueError("evolve arrays must match n_nodes")
        same_h = new_h is self.health or np.array_equal(new_h, self.health)
        if same_h and (new_p is self.p_f or self._p_close(new_p, atol)):
            return self
        return ClusterState._mint(new_h.copy(), new_p.copy(),
                                  groups=self.groups)

    def _p_close(self, new_p: np.ndarray, atol: Optional[float]) -> bool:
        if not np.array_equal(new_p > 0, self.p_f > 0):
            return False
        if atol is None:
            return True
        return bool(np.all(np.abs(new_p - self.p_f) <= atol))

    def with_health(self, ids, state: NodeHealth) -> "ClusterState":
        """New state with ``ids`` transitioned to ``state`` (no-op -> self)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_nodes):
            raise ValueError(f"node ids out of range [0, {self.n_nodes})")
        h = self.health.copy()
        h[ids] = np.int8(state)
        return self.evolve(health=h)

    def with_outage(self, p_f: np.ndarray,
                    atol: Optional[float] = 0.0) -> "ClusterState":
        """New state with a refreshed belief vector (within-``atol`` -> self)."""
        return self.evolve(p_f=p_f, atol=atol)

    # -------------------------------------------------------------- overlay
    def overlay(self, unavailable=(), *,
                route_faulty: bool = True) -> "ClusterState":
        """Derived view with extra nodes made unallocatable.

        O(n) to build, no new epoch: the key digests the masked sets, so
        two overlays of one base with the same masks share every
        epoch-keyed cache entry.  ``route_faulty`` picks the flavor:

        * ``True`` (default) — the nodes are treated as certain outages
          end to end: excluded from selection *and* penalized in the
          Eq. 1 route weights.  The right model for freshly **failed**
          nodes (``engine.replace``), and the historical behavior of
          every overlay.
        * ``False`` — the nodes are merely **busy**: excluded from
          selection, but still valid routers.  :attr:`route_key` and
          :meth:`route_outage_vector` ignore them, so route-weight
          caches key on the base health epoch — the property the online
          placement service relies on under lease churn.

        Overlaying an overlay composes each flavor's mask against the
        same base; the two flavors compose independently.
        """
        extra = np.atleast_1d(np.asarray(unavailable, dtype=np.int64))
        if extra.size == 0:
            return self
        if extra.min() < 0 or extra.max() >= self.n_nodes:
            raise ValueError(f"node ids out of range [0, {self.n_nodes})")
        prev = self.masked if route_faulty else self.masked_busy
        mask = (np.zeros(self.n_nodes, dtype=bool) if prev is None
                else prev.copy())
        mask[extra] = True
        if prev is not None and np.array_equal(mask, prev):
            return self
        faulty = _ro(mask) if route_faulty else self.masked
        busy = self.masked_busy if route_faulty else _ro(mask)
        base_key = (self.key if not self.is_overlay
                    else self.key[1])
        f_digest = (None if faulty is None
                    else np.flatnonzero(faulty).tobytes())
        b_digest = (None if busy is None
                    else np.flatnonzero(busy).tobytes())
        key = (("o", base_key, f_digest) if busy is None
               else ("ob", base_key, f_digest, b_digest))
        return ClusterState(health=self.health, p_f=self.p_f,
                            epoch=self.epoch, key=key,
                            groups=self.groups, masked=faulty,
                            masked_busy=busy)

    # ----------------------------------------------------------------- diff
    def diff(self, other: "ClusterState") -> "StateDiff":
        """Nodes whose *effective* health differs between two states.

        Effective means what a placement sees: allocatability (lifecycle
        + overlay mask) and the pinned outage vector.  ``diff`` is
        symmetric in membership: ``a.diff(b).nodes == b.diff(a).nodes``.
        """
        if other.n_nodes != self.n_nodes:
            raise ValueError("cannot diff states of different sizes")
        a_m, b_m = self.allocatable_mask(), other.allocatable_mask()
        changed = (self.health != other.health) | (a_m != b_m)
        pa, pb = self.outage_vector(), other.outage_vector()
        changed |= pa != pb
        return StateDiff(nodes=np.flatnonzero(changed),
                         old=self, new=other)


@dataclasses.dataclass(frozen=True)
class StateDiff:
    """The set of nodes whose health changed between two states."""

    nodes: np.ndarray          # changed node ids, ascending
    old: ClusterState
    new: ClusterState

    def __len__(self) -> int:
        return len(self.nodes)

    def __bool__(self) -> bool:
        return len(self.nodes) > 0

    def lost(self) -> np.ndarray:
        """Changed nodes that are allocatable in ``old`` but not ``new`` —
        the set that displaces running placements."""
        if not len(self.nodes):
            return self.nodes
        new_m = self.new.allocatable_mask()
        old_m = self.old.allocatable_mask()
        sel = old_m[self.nodes] & ~new_m[self.nodes]
        return self.nodes[sel]

    def touches(self, placement: np.ndarray) -> bool:
        """True when any changed node is used by ``placement``."""
        return bool(np.isin(np.asarray(placement), self.nodes).any())


def _freeze_groups(groups) -> Optional[tuple[tuple[int, ...], ...]]:
    if groups is None:
        return None
    return tuple(tuple(int(x) for x in np.asarray(g).ravel())
                 for g in groups)


_MAX_INTERNED = 64
_INTERNED: "OrderedDict[tuple, ClusterState]" = OrderedDict()


__all__ = ["NodeHealth", "ClusterState", "StateDiff"]
