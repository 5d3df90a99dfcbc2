"""FANS — Fault Aware Node Selection: the Slurm-integration layer.

Composes the pieces the paper wires into Slurm as five plugins:

* ``NodeRegistry``      <- FATT topology plugin (coords + routing input)
* ``HeartbeatMonitor``  <- Fault Aware Slurmctld + per-node NodeState
* ``Job.comm``          <- LoadMatrix plugin (the profiled communication
                           graph travels with the job submission)
* ``Scheduler.submit``  <- srun --distribution={linear,random,greedy,topo,
                           tofa,...}; FANS builds a PlacementRequest and the
                           shared PlacementEngine overrides the default task
                           layout

The scheduler is the **owner of the cluster's health state**: it merges
the registry's administrative lifecycle (UP / DEGRADED / DRAINED / DOWN)
with the heartbeat monitor's outage estimates into one versioned
:class:`~repro_torch.core.state.ClusterState` snapshot
(:meth:`Scheduler.cluster_state`).  A new epoch is minted **only when
health actually changes** — lifecycle transitions or an estimate moving
beyond ``p_f_atol`` (or flipping the ``p_f > 0`` pattern Eq. 1
consults) — so estimator jitter between heartbeat rounds never produces
a fresh engine cache key, and thousands of placements against a stable
cluster stay warm.  Placement requests carry the snapshot plus a cheap
*overlay* masking nodes allocated to running jobs.

Beyond the paper, the scheduler also supports *degrading* (a flaky node
whose estimate crosses ``degraded_threshold`` stays allocatable but is
marked DEGRADED so Eq. 1 steers placements around it), *draining*
(administratively removing nodes whose estimated outage crosses
``drain_threshold``, with hysteresis so recovered nodes return to
service) and *elastic re-placement*: when a running job's node goes
down, ``engine.replace`` moves only the displaced processes onto
surviving healthy nodes and the job restarts (from the latest checkpoint
if the checkpoint model is enabled in the simulator).

**Queueing.**  Nodes are allocated exclusively per running job (Slurm's
default exclusive node allocation).  ``submit`` enqueues; the pending
queue is drained FIFO against free allocatable capacity whenever
capacity changes (submit / complete / recover / undrain).  With
``backfill=True`` (default) a job behind a blocked queue head may start
early when it fits in currently-free capacity.  This is *greedy*
capacity backfill: the scheduler is clock-free, has no runtime
estimates, and makes no reservations, so — unlike EASY backfill — a
backfilled job *can* delay the blocked head (it holds nodes the head
would have received at the next completion).  Use ``backfill=False`` for
strict FIFO when head-of-line fairness matters more than utilisation.
The simulated-time event loop that drives this queue lives in
:mod:`repro_torch.sim.clustersim`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from repro_torch.cluster.heartbeat import HeartbeatMonitor, MovingAverage
from repro_torch.cluster.nodes import NodeRegistry, NodeState
from repro_torch.core.engine import (PlacementEngine, PlacementPlan,
                                     PlacementRequest)
from repro_torch.core.state import ClusterState
from repro_torch.core.topology import TorusTopology
from repro_torch.sim.jobsim import successful_runtime
from repro_torch.sim.network import TorusNetwork
from repro_torch.workloads.patterns import Workload

_job_ids = itertools.count(1)


@dataclasses.dataclass
class Job:
    workload: Workload
    distribution: str = "tofa"          # srun --distribution=
    job_id: int = dataclasses.field(default_factory=lambda: next(_job_ids))


@dataclasses.dataclass
class JobRecord:
    job: Job
    placement: Optional[PlacementPlan] = None   # None while pending
    state: str = "pending"              # pending | running | done | failed
    runtime: float = 0.0
    restarts: int = 0
    requeues: int = 0                   # times bounced back to the queue
    enqueue_time: float = 0.0           # scheduler clock at enqueue
    start_time: float = -1.0            # scheduler clock at first start


class Scheduler:
    """slurmctld with the TOFA plugin set.

    Without an ``engine`` the scheduler builds its own
    :class:`~repro_torch.core.engine.PlacementEngine` on ``device``
    (``cuda`` when omitted, which raises
    :class:`~repro_torch.core.backend.BackendUnavailableError` without a
    GPU; ``device="cpu"`` runs the plain PyTorch kernels)."""

    def __init__(
        self,
        topo: TorusTopology,
        net: TorusNetwork | None = None,
        estimator=None,
        drain_threshold: float = 0.5,
        undrain_threshold: float | None = None,
        degraded_threshold: float | None = None,
        p_f_atol: float = 0.15,
        seed: int = 0,
        engine: PlacementEngine | None = None,
        backfill: bool = True,
        tracker=None,
        device: str | None = None,
    ):
        self.registry = NodeRegistry(topo)
        self.topo = topo
        self.net = net or TorusNetwork(topo)
        self.monitor = HeartbeatMonitor(topo.n_nodes,
                                        estimator or MovingAverage())
        self.drain_threshold = drain_threshold
        # hysteresis: a DRAINED node returns to service only once its
        # estimate falls well below the drain trigger (default half)
        self.undrain_threshold = (drain_threshold / 2.0
                                  if undrain_threshold is None
                                  else undrain_threshold)
        # optional middle band: estimates in [degraded_threshold,
        # drain_threshold) mark a node DEGRADED — still allocatable, but
        # its elevated p_f makes Eq. 1 steer placements around it.
        # None (default) disables the band: UP <-> DRAINED only.
        self.degraded_threshold = degraded_threshold
        # belief-staleness bound of the published ClusterState: estimate
        # drift within +-p_f_atol (and an unchanged p_f > 0 pattern)
        # re-uses the current epoch instead of minting a new one.  Every
        # in-tree policy reads only the pattern, so sub-atol drift can
        # never change a placement — it only would have cold-started the
        # engine caches on every heartbeat round.  The 0.15 default is
        # the tightest value at which epochs track genuine failures only
        # under raw monitor jitter (the reference package's full-mode
        # serving loop: 44 epochs = churn + initial at 0.15/0.25, 47 at
        # 0.1, 107 and an 0.893 hit rate at 0.05 — below the >=95% floor
        # gated in BENCH_state; a learned BeliefTracker's exposure-only
        # drift stays at the floor at every grid point, see its
        # benchmarks/belief_sweep.py --atol-sweep); configurable here and
        # through the scenario presets' ``p_f_atol=`` kwarg.
        self.p_f_atol = p_f_atol
        # optional BeliefTracker (repro_torch.beliefs): when attached, the
        # published ClusterState carries the tracker's learned hazard
        # belief instead of the raw heartbeat estimate, and failure /
        # repair events are forwarded so the belief updates online.
        # Drain/degrade decisions stay monitor-driven either way — the
        # tracker only changes what Eq. 1 placements believe.
        self.tracker = tracker
        self.backfill = backfill
        self.rng = np.random.default_rng(seed)
        self.engine = engine or PlacementEngine(device=device)
        self.records: dict[int, JobRecord] = {}
        self.queue: list[Job] = []              # pending jobs, FIFO order
        self.allocated: dict[int, np.ndarray] = {}   # job_id -> node ids
        self._state = ClusterState.healthy(topo.n_nodes)
        # cumulative mapper wall-clock this scheduler has spent, across
        # queue drains and fault-driven re-placements (benchmarked per
        # scenario in the reference package's benchmarks/clustersim.py)
        self.place_time_s: float = 0.0
        # simulated-seconds clock, advanced by the event simulator before
        # each handler (direct callers may leave it at 0.0 — admission
        # waits then read as abstract rounds).  Feeds the queue-depth and
        # admission-latency counters reported by :meth:`stats`.
        self.clock: float = 0.0
        self.peak_queue_depth: int = 0
        self.n_enqueued: int = 0
        self.n_started: int = 0
        self._wait_total_s: float = 0.0
        self._wait_max_s: float = 0.0

    # -------------------------------------------------------------- health
    def cluster_state(self) -> ClusterState:
        """The current versioned health snapshot (FANS's world view).

        Merges registry lifecycle codes with the heartbeat belief; a new
        epoch is minted only when either actually changed (see
        ``p_f_atol``), so callers can use ``state.key`` — and the engine
        does — as a cache token that is stable across no-op heartbeat
        rounds.  With a belief tracker attached the belief is the
        tracker's learned ``p_f`` (queried at the scheduler clock so
        censored exposure stays current); otherwise the raw heartbeat
        estimate."""
        codes = self.registry.health_codes()
        if self.tracker is not None:
            p = self.tracker.p_f_vector(now=self.clock)
        else:
            p = self.monitor.outage_probabilities()
        # a non-allocatable node's belief is pinned to 1.0 in every view
        # placements consume, so its raw estimate drifting (a dead node's
        # miss fraction climbing toward 1.0) must not mint epochs
        p = np.where(codes <= np.int8(1), p, 1.0)   # 1 == DEGRADED
        self._state = self._state.evolve(health=codes, p_f=p,
                                         atol=self.p_f_atol)
        return self._state

    def heartbeat_round(self, replies: np.ndarray,
                        latencies: np.ndarray | None = None,
                        dt: float = 1.0) -> list[JobRecord]:
        """One heartbeat poll: update estimates, degrade/drain/undrain,
        and drain the pending queue if capacity came back.  Returns newly
        started records (draining never kills running jobs — Slurm
        semantics).  ``dt`` is the poll interval in simulated seconds,
        forwarded to the monitor's clock (the event simulator passes its
        ``heartbeat_interval``; the default 1.0 reads as one abstract
        round for direct callers)."""
        self.monitor.poll(replies, latencies, dt=dt)
        if self.tracker is not None:
            self.tracker.observe_heartbeat(self.clock)
        p = self.monitor.outage_probabilities()
        deg = self.degraded_threshold
        freed = False
        for i in range(self.topo.n_nodes):
            state = self.registry[i].state
            if state.allocatable and p[i] >= self.drain_threshold:
                self.registry.mark([i], NodeState.DRAINED)
            elif state == NodeState.DRAINED and p[i] < self.undrain_threshold:
                back = (NodeState.DEGRADED
                        if deg is not None and p[i] >= deg else NodeState.UP)
                self.registry.mark([i], back)
                freed = True
            elif deg is not None:
                if state == NodeState.UP and p[i] >= deg:
                    self.registry.mark([i], NodeState.DEGRADED)
                elif state == NodeState.DEGRADED and p[i] < deg / 2.0:
                    # same hysteresis shape as undrain: recover only once
                    # the evidence has clearly faded
                    self.registry.mark([i], NodeState.UP)
        return self.schedule_pending() if freed else []

    def estimated_outage(self) -> np.ndarray:
        """p_f as FANS sees it: the current state's pinned outage vector —
        heartbeat belief for allocatable nodes (DEGRADED keeps its
        elevated estimate), DRAINED/DOWN pinned to certain outage."""
        return self.cluster_state().outage_vector()

    # ----------------------------------------------------------- capacity
    def free_ids(self) -> np.ndarray:
        """Allocatable (UP/DEGRADED) nodes not held by any running job,
        in id order."""
        ok = self.registry.allocatable_ids()
        if not self.allocated:
            return ok
        busy = np.concatenate(list(self.allocated.values()))
        return ok[~np.isin(ok, busy)]

    # ---------------------------------------------------------- placement
    def placement_request(self, job: Job,
                          available: np.ndarray | None = None
                          ) -> PlacementRequest:
        """FANS inputs: G from LoadMatrix, H from FATT, and one versioned
        ClusterState carrying p_f (heartbeat belief) and availability —
        busy allocations enter as a cheap overlay on the snapshot, so the
        epoch (and every engine cache keyed on it) survives until health
        actually changes.

        An explicit ``available`` that is an id-ordered subset of the
        allocatable set (what :meth:`free_ids` produces) rides the
        overlay; anything else — a custom order, or a what-if list
        naming drained/down nodes — is passed verbatim through the
        legacy request path so the caller's intent is honored exactly."""
        state = self.cluster_state()
        if available is None:
            available = self.free_ids()
        else:
            available = np.asarray(available, dtype=np.int64)
            alloc = state.available_ids()
            ordered_subset = np.isin(available, alloc).all() and \
                np.array_equal(available, alloc[np.isin(alloc, available)])
            if not ordered_subset:
                return PlacementRequest(
                    comm=job.workload.comm, topology=self.topo,
                    p_f=state.outage_vector(), available=available)
        unavailable = np.setdiff1d(state.available_ids(), available)
        return PlacementRequest(
            comm=job.workload.comm,
            topology=self.topo,
            state=state.overlay(unavailable=unavailable),
        )

    # ------------------------------------------------------------- running
    def enqueue(self, job: Job) -> JobRecord:
        """Append to the pending queue without draining it — for callers
        (the event simulator) that need :meth:`schedule_pending`'s list
        of started records themselves."""
        rec = JobRecord(job=job, enqueue_time=self.clock)
        self.records[job.job_id] = rec
        self.queue.append(job)
        self.n_enqueued += 1
        self.peak_queue_depth = max(self.peak_queue_depth, len(self.queue))
        return rec

    def submit(self, job: Job) -> JobRecord:
        """Enqueue and try to start.  The returned record is ``running``
        (with a placement) if capacity allowed, else ``pending``; other
        queued jobs may start too as a side effect."""
        rec = self.enqueue(job)
        self.schedule_pending()
        return rec

    def schedule_pending(self) -> list[JobRecord]:
        """Drain the pending queue FIFO against free capacity.

        Without backfill, scanning stops at the first job that does not
        fit (strict FIFO).  With backfill, later jobs are still tried —
        a small job can slip past a blocked wide head into currently-free
        nodes.  Greedy, reservation-free: the backfilled job may hold
        nodes the head would have received at the next completion, so
        wide jobs can be delayed by a stream of small ones (no starvation
        bound; use ``backfill=False`` for strict FIFO fairness).

        Admission is decided first by capacity *count* (each job takes
        exactly ``n_ranks`` exclusive nodes, so which jobs start is
        placement-independent), then every admitted job is placed with
        **one** :meth:`PlacementEngine.place_many` call in exclusive
        mode — the whole drain shares one backend scope, one set of
        epoch-keyed (topology, state) matrices, and the shrinking
        availability mask is threaded through the batch as state
        overlays exactly as the old per-job loop did (bit-identical
        placements and RNG draws).
        """
        remaining: list[Job] = []
        admitted: list[Job] = []
        free = self.free_ids()
        free_count = len(free)
        blocked = False
        for job in self.queue:
            if blocked and not self.backfill:
                remaining.append(job)
                continue
            if free_count < job.workload.n_ranks:
                remaining.append(job)
                blocked = True
                continue
            admitted.append(job)
            free_count -= job.workload.n_ranks
        self.queue = remaining
        if not admitted:
            return []

        plans = self.engine.place_many(
            [self.placement_request(job, free) for job in admitted],
            policy=[job.distribution for job in admitted],
            rng=self.rng, exclusive=True)
        started: list[JobRecord] = []
        for job, plan in zip(admitted, plans):
            rec = self.records[job.job_id]
            rec.placement = plan
            rec.state = "running"
            if rec.start_time < 0:
                rec.start_time = self.clock
                wait = max(0.0, self.clock - rec.enqueue_time)
                self.n_started += 1
                self._wait_total_s += wait
                self._wait_max_s = max(self._wait_max_s, wait)
            rec.runtime = successful_runtime(job.workload, plan.placement,
                                             self.net)
            self.allocated[job.job_id] = np.asarray(plan.placement,
                                                    dtype=np.int64).copy()
            self.place_time_s += plan.wall_time_s
            started.append(rec)
        return started

    def handle_node_failure(self, node_ids) -> list[JobRecord]:
        """Elastic re-placement (beyond paper): nodes went down; any running
        job holding them is incrementally re-placed on surviving nodes —
        only the displaced processes move — and restarted.  A job the
        survivors cannot hold goes back to the head of the pending queue
        (``state="pending"``).  Returns every affected record.

        This method does *not* drain the pending queue, so the caller can
        distinguish affected records from newly started ones: if a
        requeued job released capacity another pending job fits in, call
        :meth:`schedule_pending` afterwards (the event simulator does)."""
        node_ids = [int(x) for x in np.atleast_1d(node_ids)]
        if self.tracker is not None:
            self.tracker.observe_failure(node_ids, self.clock)
        self.registry.mark(node_ids, NodeState.DOWN)
        affected = []
        requeued: list[Job] = []
        for rec in self.records.values():
            if rec.state != "running":
                continue
            used = set(int(x) for x in rec.placement.placement)
            if not (used & set(node_ids)):
                continue
            affected.append(rec)
            # free this job's own allocation before re-placing so its
            # surviving nodes remain usable by the replacement
            del self.allocated[rec.job.job_id]
            try:
                # pass the *current* snapshot (busy allocations overlaid)
                # — the plan's request carries the submit-time state,
                # stale once other nodes failed or drained after
                # submission
                state = self.cluster_state()
                busy = np.setdiff1d(state.available_ids(), self.free_ids())
                rec.placement = self.engine.replace(
                    rec.placement, node_ids, rng=self.rng,
                    state=state.overlay(unavailable=busy))
            except ValueError:
                # survivors cannot hold the job: back to the queue head
                rec.placement = None
                rec.state = "pending"
                rec.requeues += 1
                requeued.append(rec.job)
                continue
            rec.restarts += 1
            self.place_time_s += rec.placement.wall_time_s
            rec.runtime = successful_runtime(rec.job.workload,
                                             rec.placement.placement,
                                             self.net)
            self.allocated[rec.job.job_id] = np.asarray(
                rec.placement.placement, dtype=np.int64).copy()
        if requeued:
            self.queue = requeued + self.queue
        return affected

    def recover(self, node_ids) -> list[JobRecord]:
        """Repaired nodes return to service; returns newly started records.

        A repaired node whose heartbeat estimate still sits at or above
        ``drain_threshold`` comes back DRAINED, not UP — repair fixes the
        outage, not the flakiness evidence, so the undrain hysteresis in
        :meth:`heartbeat_round` keeps gating its return to placements.
        With the degraded band enabled, an estimate in [degraded, drain)
        brings the node back DEGRADED."""
        if self.tracker is not None:
            self.tracker.observe_repair(
                [int(x) for x in np.atleast_1d(node_ids)], self.clock)
        p = self.monitor.outage_probabilities()
        deg = self.degraded_threshold
        for i in (int(x) for x in np.atleast_1d(node_ids)):
            if p[i] >= self.drain_threshold:
                state = NodeState.DRAINED
            elif deg is not None and p[i] >= deg:
                state = NodeState.DEGRADED
            else:
                state = NodeState.UP
            self.registry.mark([i], state)
        return self.schedule_pending()

    def complete(self, job_id: int) -> list[JobRecord]:
        """Mark done, release nodes, and drain the queue onto the freed
        capacity; returns newly started records."""
        self.records[job_id].state = "done"
        self.allocated.pop(job_id, None)
        return self.schedule_pending()

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Queueing and admission-latency counters of this scheduler.

        Waits are measured on :attr:`clock` (simulated seconds when the
        event simulator drives it, abstract otherwise) from enqueue to
        *first* start — requeues after a failure do not reset the clock,
        matching how users experience time-to-start."""
        return {
            "queue_depth": len(self.queue),
            "peak_queue_depth": self.peak_queue_depth,
            "n_enqueued": self.n_enqueued,
            "n_started": self.n_started,
            "admission_wait_total_s": self._wait_total_s,
            "admission_wait_max_s": self._wait_max_s,
            "admission_wait_mean_s": (self._wait_total_s / self.n_started
                                      if self.n_started else 0.0),
            "place_time_s": self.place_time_s,
        }
