"""PlacementService — the online, event-driven placement loop.

Where the batch scheduler (:mod:`repro_torch.cluster.scheduler`) drains a
FIFO queue when capacity changes, this service runs serving traffic:
requests arrive continuously, are admitted through SLO lanes
(:class:`~repro_torch.service.queue.AdmissionQueue`), and are placed in
batched *drain ticks* — one
:meth:`~repro_torch.core.engine.PlacementEngine.place_many` call per tick
— against a single versioned :class:`~repro_torch.core.state.ClusterState`
the service owns.  Failures, recoveries and heartbeats arrive as events on
the deterministic :class:`~repro_torch.sim.events.EventQueue` and drive
diff-style incremental re-placement (:meth:`PlacementEngine.replace`),
elastic replica resize, and SLO preemption.

**Cache discipline.**  Every view the service hands the engine is a
*busy-flavored* overlay (``overlay(..., route_faulty=False)``) of its
base state: leased nodes are excluded from selection but remain valid
routers, so the overlay's ``route_key`` — and with it the engine's
weight-matrix and memo-dict cache keys — stays the base health epoch.
Lease churn (every tick has a different busy set) therefore never
cold-starts a cache; only *health* changes (failures, recoveries,
beyond-``p_f_atol`` belief moves) mint epochs.  This is the property the
storm benchmark (the reference package's ``benchmarks/serve_storm.py``)
gates at a >= 0.90 hit rate.

**Device.**  The service builds its engine on ``device`` (``cuda`` when
omitted, which raises
:class:`~repro_torch.core.backend.BackendUnavailableError` without a GPU;
``device="cpu"`` runs the plain PyTorch kernels); an ``engine=`` given by
the caller is used as it is.  Queueing, leases, events and the network
model stay host NumPy, so with integer-weighted guests every simulated
field and the placement log equal the reference package's service.

**Determinism.**  One ``numpy.random.Generator`` (from ``seed``) feeds
every placement; events sort by the queue's total order; and the service
appends each placement to ``placement_log`` — two runs with equal seeds
and inputs produce identical logs bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.engine import (PlacementEngine, PlacementPlan,
                                     PlacementRequest)
from repro_torch.core.state import ClusterState, NodeHealth
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.queue import AdmissionQueue
from repro_torch.service.requests import (ServiceReply, ServiceRequest,
                                          SLOClass)
from repro_torch.sim.events import EventQueue, EventType
from repro_torch.sim.jobsim import successful_runtime
from repro_torch.sim.network import network_for
from repro_torch.workloads.patterns import Workload


@dataclasses.dataclass
class _Lease:
    """One running allocation: current shape, nodes and completion state.

    ``epoch`` invalidates stale COMPLETE events: every re-placement,
    preemption or resize bumps it, and a COMPLETE carrying an older epoch
    is dropped (the event-queue lazy-invalidation protocol).  ``plan`` is
    the engine plan backing ``nodes`` — ``None`` after an elastic resize,
    when the placement is no longer a single engine plan and a failure
    triggers a full re-place of the current workload instead of the
    incremental path."""

    req: ServiceRequest
    workload: Workload
    nodes: np.ndarray
    n_replicas: int
    epoch: int = 0
    t_placed: float = 0.0
    service_time: float = 0.0
    t_complete: float = 0.0
    plan: Optional[PlacementPlan] = None


@dataclasses.dataclass
class ServiceResult:
    """What :meth:`PlacementService.run` returns."""

    replies: dict                 # req_id -> ServiceReply
    metrics: ServiceMetrics
    row: dict                     # BENCH-shaped flat summary
    placement_log: list           # (req_id, node tuple) in decision order
    makespan: float               # simulated seconds to the last event
    n_events: int
    hit_rate: float               # engine cache hit rate over the run
    wall_time_s: float


class PlacementService:
    """Long-running fault-aware placement service over one topology."""

    def __init__(self, topo, *, engine: Optional[PlacementEngine] = None,
                 policy: str = "tofa", drain_interval: float = 0.25,
                 restart_delay: float = 1.0, p_f_atol: float = 0.25,
                 seed: int = 0, net=None,
                 queue: Optional[AdmissionQueue] = None,
                 metrics: Optional[ServiceMetrics] = None,
                 device: Optional[str] = None):
        if drain_interval <= 0:
            raise ValueError(
                f"drain_interval must be > 0, got {drain_interval}")
        self.topo = topo
        self.engine = engine or PlacementEngine(default_policy=policy,
                                                device=device)
        self.policy = policy
        self.net = net or network_for(topo)
        self.drain_interval = drain_interval
        self.restart_delay = restart_delay
        self.p_f_atol = p_f_atol
        self.rng = np.random.default_rng(seed)
        self.queue = queue or AdmissionQueue()
        self.metrics = metrics or ServiceMetrics()
        self.events = EventQueue()
        self.state = ClusterState.healthy(topo.n_nodes)
        self.leases: dict[int, _Lease] = {}
        self.replies: dict[int, ServiceReply] = {}
        self.placement_log: list[tuple[int, tuple]] = []
        self._tick_pending = False

    # ------------------------------------------------------------ views
    def busy_nodes(self, exclude: Optional[int] = None) -> np.ndarray:
        """Node ids held by current leases (minus ``exclude``'s own)."""
        held = [l.nodes for rid, l in self.leases.items() if rid != exclude]
        if not held:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(held)

    def busy_view(self, exclude: Optional[int] = None) -> ClusterState:
        """The engine-facing state: base health with every leased node
        masked busy (``route_faulty=False`` — still a valid router, so
        the route-weight caches keep keying on the base epoch)."""
        return self.state.overlay(self.busy_nodes(exclude),
                                  route_faulty=False)

    def free_capacity(self) -> int:
        return len(self.busy_view().available_ids())

    # ----------------------------------------------------------- admission
    def submit(self, req: ServiceRequest, now: float) -> ServiceReply:
        """Admit one request into its SLO lane (or shed/reject it)."""
        reply = ServiceReply(req_id=req.req_id, slo=req.slo,
                             submit_time=now)
        self.replies[req.req_id] = reply
        self.metrics.submitted += 1
        if self.queue.push(req, now):
            reply.status = "queued"
            self._schedule_tick(now)
        elif req.deadline <= now:
            reply.status = "shed"
            self.metrics.shed += 1
        else:
            reply.status = "rejected"
            self.metrics.rejected += 1
        return reply

    def _schedule_tick(self, now: float) -> None:
        if not self._tick_pending and self.queue:
            self._tick_pending = True
            self.events.push(now + self.drain_interval, EventType.START)

    # --------------------------------------------------------- drain tick
    def tick(self, now: float) -> None:
        """Run one drain tick immediately (direct-drive entry point for
        tests and external loops; :meth:`run` schedules these as START
        events on the drain interval)."""
        self._drain(now)

    def _drain(self, now: float) -> None:
        self._tick_pending = False
        self.metrics.drain_ticks += 1
        for req in self.queue.shed_expired(now):
            self.replies[req.req_id].status = "shed"
            self.metrics.shed += 1
        self._preempt_for_pressure(now)
        batch = self.queue.drain(now, self.free_capacity())
        if batch:
            self._place_batch(batch, now)
        self.metrics.sample_queue_depth(self.queue.depth)
        self._schedule_tick(now)

    def _preempt_for_pressure(self, now: float) -> None:
        """Evict best-effort leases (newest first) while the interactive
        lane's head cannot fit in free capacity.  Victims go back to
        their lane — preemption is a requeue, not a kill."""
        head = self.queue.head(SLOClass.INTERACTIVE)
        while head is not None:
            if self.free_capacity() >= head.n_ranks:
                return
            victims = [l for l in self.leases.values()
                       if l.req.slo == SLOClass.BEST_EFFORT]
            if not victims:
                return
            victim = max(victims, key=lambda l: (l.t_placed, l.req.req_id))
            self._evict(victim, now, kind="preempted")
            head = self.queue.head(SLOClass.INTERACTIVE)

    def _evict(self, lease: _Lease, now: float, kind: str) -> None:
        """Release a lease and send its request back through admission."""
        del self.leases[lease.req.req_id]
        reply = self.replies[lease.req.req_id]
        if kind == "preempted":
            reply.preemptions += 1
            self.metrics.preempted += 1
        if self.queue.push(lease.req, now):
            reply.status = "queued"
            self.metrics.requeued += 1
        elif lease.req.deadline <= now:
            reply.status = "shed"
            self.metrics.shed += 1
        else:
            reply.status = "rejected"
            self.metrics.rejected += 1

    def _place_batch(self, batch: Sequence[ServiceRequest],
                     now: float) -> None:
        view = self.busy_view()
        requests = [PlacementRequest(comm=req.workload.comm,
                                     topology=self.topo, state=view,
                                     seed=req.req_id)
                    for req in batch]
        plans = self.engine.place_many(
            requests, policy=[req.policy or self.policy for req in batch],
            rng=self.rng, exclusive=True, route_faulty=False)
        for req, plan in zip(batch, plans):
            first = self.replies[req.req_id].placed_time < 0
            self._start_lease(req, plan.placement, now, plan=plan)
            self.metrics.placed += 1
            self.metrics.place_wall_s += plan.wall_time_s
            if first:                          # first placement only
                self.metrics.admission.observe(
                    now - self.replies[req.req_id].submit_time)

    def _start_lease(self, req: ServiceRequest, nodes: np.ndarray,
                     now: float, plan: Optional[PlacementPlan] = None,
                     workload: Optional[Workload] = None,
                     n_replicas: Optional[int] = None) -> _Lease:
        wl = workload if workload is not None else req.workload
        nodes = np.asarray(nodes, dtype=np.int64).copy()
        prev = self.leases.get(req.req_id)
        lease = _Lease(req=req, workload=wl, nodes=nodes,
                       n_replicas=(n_replicas if n_replicas is not None
                                   else req.n_replicas),
                       epoch=(prev.epoch + 1 if prev is not None else 0),
                       t_placed=now, plan=plan)
        lease.service_time = (req.hold_time if req.hold_time is not None
                              else successful_runtime(wl, nodes, self.net))
        lease.t_complete = now + lease.service_time
        self.leases[req.req_id] = lease
        self.events.push(lease.t_complete, EventType.COMPLETE,
                         req_id=req.req_id, epoch=lease.epoch)
        reply = self.replies[req.req_id]
        reply.status = "placed"
        reply.placed_time = now
        reply.nodes = nodes
        self.placement_log.append(
            (req.req_id, tuple(int(x) for x in nodes)))
        return lease

    def _reschedule(self, lease: _Lease, new_nodes: np.ndarray,
                    now: float, plan: Optional[PlacementPlan]) -> None:
        """Move a lease onto ``new_nodes`` preserving progress: remaining
        work is rescaled by the new placement's runtime ratio, plus the
        restart penalty."""
        frac = max(0.0, (lease.t_complete - now) / lease.service_time) \
            if lease.service_time > 0 else 0.0
        req = lease.req
        new_runtime = (req.hold_time if req.hold_time is not None
                       else successful_runtime(lease.workload, new_nodes,
                                               self.net))
        lease.nodes = np.asarray(new_nodes, dtype=np.int64).copy()
        lease.plan = plan
        lease.service_time = new_runtime
        lease.epoch += 1
        lease.t_complete = now + frac * new_runtime + self.restart_delay
        self.events.push(lease.t_complete, EventType.COMPLETE,
                         req_id=req.req_id, epoch=lease.epoch)
        self.replies[req.req_id].nodes = lease.nodes
        self.placement_log.append(
            (req.req_id, tuple(int(x) for x in lease.nodes)))

    # ------------------------------------------------------------ lifecycle
    def _complete(self, req_id: int, epoch: int, now: float) -> None:
        lease = self.leases.get(req_id)
        if lease is None or lease.epoch != epoch:
            return                         # superseded attempt: drop
        del self.leases[req_id]
        reply = self.replies[req_id]
        reply.status = "completed"
        reply.finish_time = now
        self.metrics.completed += 1
        self.metrics.completion.observe(now - reply.submit_time)
        self._schedule_tick(now)

    def handle_failure(self, nodes, now: float) -> list[int]:
        """Nodes went DOWN: mint the new health epoch, then walk every
        lease through :meth:`PlacementEngine.replace` — the engine's fast
        path skips untouched leases, touched ones get incremental
        re-placement on the survivors (or a requeue when the survivors
        cannot hold them).  Returns the touched req_ids."""
        nodes = np.atleast_1d(np.asarray(nodes, dtype=np.int64))
        self.metrics.failure_events += 1
        self.state = self.state.with_health(nodes, NodeHealth.DOWN)
        touched: list[int] = []
        for req_id in list(self.leases):
            lease = self.leases[req_id]
            if not np.isin(lease.nodes, nodes).any():
                if lease.plan is not None:
                    # engine fast path: diff misses this placement
                    same = self.engine.replace(lease.plan, nodes,
                                               state=self.busy_view(req_id),
                                               rng=self.rng)
                    assert same is lease.plan
                    self.metrics.replace_skipped += 1
                continue
            touched.append(req_id)
            self.replies[req_id].replacements += 1
            view = self.busy_view(exclude=req_id)
            try:
                if lease.plan is not None:
                    plan = self.engine.replace(lease.plan, nodes,
                                               state=view, rng=self.rng)
                else:
                    # resized lease: no single plan backs it — full
                    # re-place of the current workload on the survivors
                    plan = self.engine.place(
                        PlacementRequest(comm=lease.workload.comm,
                                         topology=self.topo, state=view,
                                         seed=req_id),
                        policy=lease.req.policy or self.policy,
                        rng=self.rng)
            except ValueError:
                self._evict(lease, now, kind="failed-over")
                continue
            self.metrics.replaced += 1
            self.metrics.place_wall_s += plan.wall_time_s
            self._reschedule(lease, plan.placement, now, plan)
        self._schedule_tick(now)
        return touched

    def handle_recover(self, nodes, now: float) -> None:
        """Repaired nodes return to service (capacity may unblock the
        queue, so a drain tick is scheduled)."""
        nodes = np.atleast_1d(np.asarray(nodes, dtype=np.int64))
        self.state = self.state.with_health(nodes, NodeHealth.UP)
        self._schedule_tick(now)

    def heartbeat(self, p_f: np.ndarray, now: float) -> None:
        """Refresh the outage belief.  Within-``p_f_atol`` jitter (with an
        unchanged ``p_f > 0`` pattern) reuses the current epoch — the
        engine caches stay warm across no-op heartbeat rounds."""
        self.metrics.heartbeats += 1
        self.state = self.state.with_outage(
            np.asarray(p_f, dtype=np.float64), atol=self.p_f_atol)

    # ------------------------------------------------------------- resize
    def resize(self, req_id: int, n_replicas: int, now: float) -> _Lease:
        """Elastically grow or shrink a replica-set lease.

        Growth places only the *added* replica blocks (against the busy
        view — existing nodes, including this lease's own, stay put);
        shrink frees whole trailing replica blocks.  Remaining completion
        time is rescaled to the new shape's runtime."""
        lease = self.leases.get(req_id)
        if lease is None:
            raise KeyError(f"no active lease for request {req_id}")
        spec = lease.req.replica_spec
        if spec is None:
            raise ValueError(f"request {req_id} is not a replica set")
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if n_replicas == lease.n_replicas:
            return lease
        rpr = spec.ranks_per_replica
        if n_replicas > lease.n_replicas:
            delta_wl = spec.workload(n_replicas - lease.n_replicas)
            plan = self.engine.place(
                PlacementRequest(comm=delta_wl.comm, topology=self.topo,
                                 state=self.busy_view(), seed=req_id),
                policy=lease.req.policy or self.policy, rng=self.rng)
            self.metrics.place_wall_s += plan.wall_time_s
            new_nodes = np.concatenate([lease.nodes, plan.placement])
        else:
            new_nodes = lease.nodes[:n_replicas * rpr]
        lease.workload = spec.workload(n_replicas)
        lease.n_replicas = n_replicas
        self.metrics.resized += 1
        # the merged allocation is no longer one engine plan: failures on
        # this lease now take the full re-place path
        self._reschedule(lease, new_nodes, now, plan=None)
        self._schedule_tick(now)
        return lease

    # ---------------------------------------------------------------- run
    def run(self, requests: Sequence[ServiceRequest], *,
            failures: Sequence = (), recoveries: Sequence = (),
            heartbeat_interval: Optional[float] = None,
            belief: Optional[np.ndarray] = None,
            belief_jitter: float = 0.0,
            horizon: Optional[float] = None,
            heartbeat_seed: int = 1) -> ServiceResult:
        """Drive the service to completion over a request stream.

        ``failures`` / ``recoveries`` are ``(time, node_ids)`` pairs;
        ``belief`` is the heartbeat-reported outage vector, re-published
        every ``heartbeat_interval`` with multiplicative noise of
        relative magnitude ``belief_jitter`` on its nonzero entries (the
        zero pattern is preserved, so jitter models estimator noise, not
        phantom faults).  ``horizon`` drops events past a cutoff."""
        t_wall = time.perf_counter()
        for req in requests:
            self.events.push(req.submit_time, EventType.SUBMIT, req=req)
        for t, nodes in failures:
            self.events.push(float(t), EventType.FAILURE, nodes=nodes)
        for t, nodes in recoveries:
            self.events.push(float(t), EventType.RECOVER, nodes=nodes)
        hb_rng = np.random.default_rng(heartbeat_seed)
        if heartbeat_interval is not None:
            self.events.push(heartbeat_interval, EventType.HEARTBEAT)
        makespan = 0.0
        n_events = 0
        while self.events:
            ev = self.events.pop()
            now = ev.time
            if horizon is not None and now > horizon:
                break
            n_events += 1
            makespan = now
            if ev.type == EventType.SUBMIT:
                self.submit(ev["req"], now)
            elif ev.type == EventType.START:
                self._drain(now)
            elif ev.type == EventType.COMPLETE:
                self._complete(ev["req_id"], ev["epoch"], now)
            elif ev.type == EventType.FAILURE:
                self.handle_failure(ev["nodes"], now)
            elif ev.type == EventType.RECOVER:
                self.handle_recover(ev["nodes"], now)
            elif ev.type == EventType.HEARTBEAT:
                if belief is not None:
                    p = np.asarray(belief, dtype=np.float64).copy()
                    if belief_jitter > 0.0:
                        nz = p > 0
                        noise = hb_rng.uniform(-belief_jitter,
                                               belief_jitter, nz.sum())
                        p[nz] = np.clip(p[nz] * (1.0 + noise), 1e-6, 1.0)
                    self.heartbeat(p, now)
                else:
                    self.metrics.heartbeats += 1
                # keep polling while any work remains anywhere
                if self.events or self.queue:
                    self.events.push(now + heartbeat_interval,
                                     EventType.HEARTBEAT)
        wall = time.perf_counter() - t_wall
        row = dict(self.metrics.to_row(),
                   makespan_s=makespan, n_events=n_events,
                   hit_rate=self.engine.cache_hit_rate(),
                   epoch=self.state.epoch, wall_time_s=wall)
        return ServiceResult(replies=self.replies, metrics=self.metrics,
                             row=row, placement_log=self.placement_log,
                             makespan=makespan, n_events=n_events,
                             hit_rate=self.engine.cache_hit_rate(),
                             wall_time_s=wall)


__all__ = ["PlacementService", "ServiceResult"]
