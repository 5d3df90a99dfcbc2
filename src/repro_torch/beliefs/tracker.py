"""Event-driven belief tracker: O(1)-per-event lifetime accounting.

:class:`BeliefTracker` is the mutable half of the belief subsystem: it
consumes the same failure / repair / heartbeat stream the scheduler
already sees (:class:`~repro_torch.cluster.failures.NodeEvent` semantics —
``Scheduler.handle_node_failure`` / ``Scheduler.recover`` forward to it
when attached) and maintains the :class:`~repro_torch.beliefs.estimators.
LifetimeStats` sufficient statistics incrementally — constant work per
event, never a history replay.  Any :class:`~repro_torch.beliefs.estimators.
BeliefModel` then turns those statistics into a per-node ``p_f`` vector
on demand.

Two properties matter for the placement loop:

* **Pattern hygiene** — Eq. 1 consumers read the ``p_f > 0`` indicator,
  so the tracker clamps beliefs below ``p_floor`` to exactly 0.0.
  Without the floor every node carries residual prior mass, the faulty
  pattern saturates, and fault-aware placement degenerates to uniform
  avoidance.
* **Cache friendliness** — between genuine pattern changes the belief
  drifts only as exposure accumulates, which is smooth and tiny per
  heartbeat round; ``ClusterState.evolve``'s atol interning (scheduler
  ``p_f_atol``) absorbs it, so tracker jitter never mints epochs or
  cold-starts engine weight caches (the reference package gates a ≥95%
  hit rate: ``tests/test_beliefs.py``, ``benchmarks/belief_sweep.py``).

Overlapping outages (a rack event downing an already-down node) are
reference-counted like ``ClusterSim``'s ``_down_count`` so a node only
closes one lifetime per up→down transition.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from .estimators import BeliefModel, LifetimeStats


class BeliefTracker:
    """Incremental per-node lifetime statistics + a pluggable belief model.

    Parameters
    ----------
    n_nodes:
        Cluster size; all event node ids must be ``< n_nodes``.
    model:
        The :class:`BeliefModel` queried by :meth:`p_f_vector`.
    horizon:
        Default job-duration window (simulated seconds) for belief
        queries; per-query override via ``p_f_vector(duration=...)``.
    p_floor:
        Emission floor: beliefs strictly below this are clamped to 0.0
        so residual prior mass on healthy nodes never flips the Eq. 1
        fault pattern.  Set to 0.0 to disable (calibration studies).
    t0:
        Clock origin; all nodes start up at ``t0``.
    """

    def __init__(self, n_nodes: int, model: BeliefModel, *,
                 horizon: float = 1.0, p_floor: float = 0.02,
                 t0: float = 0.0):
        if n_nodes <= 0:
            raise ValueError("n_nodes must be positive")
        if horizon <= 0:
            raise ValueError("horizon must be positive")
        self.n_nodes = int(n_nodes)
        self.model = model
        self.horizon = float(horizon)
        self.p_floor = float(p_floor)
        self.now = float(t0)
        self._n_failures = np.zeros(n_nodes, dtype=np.float64)
        self._closed_exposure = np.zeros(n_nodes, dtype=np.float64)
        self._sum_life = np.zeros(n_nodes, dtype=np.float64)
        self._sum_life_sq = np.zeros(n_nodes, dtype=np.float64)
        self._up_since = np.full(n_nodes, float(t0), dtype=np.float64)
        self._down_count = np.zeros(n_nodes, dtype=np.int64)
        self.events_ingested = 0

    # ------------------------------------------------------------ ingestion
    @staticmethod
    def _ids(nodes: Iterable[int] | int) -> np.ndarray:
        arr = np.atleast_1d(np.asarray(nodes, dtype=np.int64))
        return arr

    def observe_failure(self, nodes: Iterable[int] | int, t: float) -> None:
        """Ingest a failure event downing ``nodes`` at time ``t``.

        Nodes transitioning up→down close one completed lifetime (time
        since their last repair); nodes already down only bump the
        overlap refcount.  O(len(nodes)) work, vectorized.
        """
        ids = self._ids(nodes)
        t = float(t)
        self.now = max(self.now, t)
        was_up = self._down_count[ids] == 0
        up_ids = ids[was_up]
        life = np.maximum(0.0, t - self._up_since[up_ids])
        self._n_failures[up_ids] += 1.0
        self._closed_exposure[up_ids] += life
        self._sum_life[up_ids] += life
        self._sum_life_sq[up_ids] += life * life
        self._down_count[ids] += 1
        self.events_ingested += 1

    def observe_repair(self, nodes: Iterable[int] | int, t: float) -> None:
        """Ingest a repair event; nodes whose overlap refcount reaches 0
        start a fresh (censored-until-failure) up interval at ``t``.  A
        spurious repair of an already-up node is a no-op (its running
        censored interval is preserved, not restarted)."""
        ids = self._ids(nodes)
        t = float(t)
        self.now = max(self.now, t)
        was_down = self._down_count[ids] > 0
        self._down_count[ids] = np.maximum(self._down_count[ids] - 1, 0)
        newly_up = ids[was_down & (self._down_count[ids] == 0)]
        self._up_since[newly_up] = t
        self.events_ingested += 1

    def observe_heartbeat(self, t: float) -> None:
        """Advance the clock from a heartbeat round — accrues censored
        exposure on every up node without touching any per-node state
        (exposure is materialized lazily at query time)."""
        self.now = max(self.now, float(t))
        self.events_ingested += 1

    def advance(self, t: float) -> None:
        """Advance the clock without counting an ingested event."""
        self.now = max(self.now, float(t))

    def rebase(self, t0: float = 0.0) -> None:
        """Shift the clock origin to ``t0`` while preserving accumulated
        statistics — used after pre-training on a generated trace whose
        time base differs from the live scenario's.  All nodes are
        treated as up at ``t0`` (a mid-outage training tail does not leak
        a down state into the live run)."""
        shift = self.now - float(t0)
        self._up_since -= shift
        self._up_since[self._down_count > 0] = float(t0)
        self._down_count[:] = 0
        self.now = float(t0)

    def ingest_events(self, events: Sequence, t_end: Optional[float] = None
                      ) -> None:
        """Replay a :meth:`FailureProcess.generate` trace (training /
        backfill path — the live path is the per-event observers)."""
        for ev in events:
            if ev.kind == "fail":
                self.observe_failure(list(ev.nodes), ev.time)
            elif ev.kind == "recover":
                self.observe_repair(list(ev.nodes), ev.time)
        if t_end is not None:
            self.advance(t_end)

    # -------------------------------------------------------------- queries
    def stats(self, now: Optional[float] = None) -> LifetimeStats:
        """Current sufficient statistics; ``exposure`` includes each up
        node's censored interval through ``now``."""
        if now is not None:
            self.advance(now)
        up = self._down_count == 0
        censored = np.where(up, np.maximum(0.0, self.now - self._up_since),
                            0.0)
        return LifetimeStats(
            n_failures=self._n_failures.copy(),
            exposure=self._closed_exposure + censored,
            sum_life=self._sum_life.copy(),
            sum_life_sq=self._sum_life_sq.copy(),
            down=~up,
        )

    def p_f_vector(self, now: Optional[float] = None,
                   duration: Optional[float] = None) -> np.ndarray:
        """Belief vector ``P(>= 1 failure within `duration`)`` per node,
        clamped to [0, 1] with the ``p_floor`` emission floor applied."""
        d = self.horizon if duration is None else float(duration)
        p = np.clip(self.model.p_f(self.stats(now), d), 0.0, 1.0)
        if self.p_floor > 0.0:
            p[p < self.p_floor] = 0.0
        return p


__all__ = ["BeliefTracker"]
