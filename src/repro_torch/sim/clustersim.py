"""Event-driven cluster simulator: many jobs, one shared cluster, real time.

:mod:`repro_torch.sim.batchsim` reproduces the paper's Section 5.2 protocol with
closed-form accounting — one job at a time, failures sampled per attempt.
This module generalises it to a discrete-event simulation where **many
jobs share the cluster concurrently**: a :class:`~repro_torch.cluster.scheduler.
Scheduler` queues and backfills jobs over free capacity, heartbeat rounds
drive the outage estimator, nodes fail and are repaired *over time*
(:class:`~repro_torch.cluster.failures.FailureProcess`), and a mid-run failure
aborts the jobs holding the node, re-places them incrementally
(``engine.replace``) and restarts them from their latest checkpoint.

Every queue-drain tick (SUBMIT / COMPLETE / RECOVER / HEARTBEAT
handlers) places all runnable queued jobs with **one batched**
:meth:`~repro_torch.core.engine.PlacementEngine.place_many` call in exclusive
mode, so a drain shares one backend scope and one set of cached
(topology, health) matrices across the jobs it starts; the cumulative
mapper wall-clock is reported as :attr:`SimResult.place_time_s`.

Event semantics (tie-breaks in :class:`~repro_torch.sim.events.EventType`):

=========== ===============================================================
SUBMIT      a job enters the pending queue; the scheduler drains the queue
START       a (re)started attempt begins executing on its placement
CHECKPOINT  a running attempt preserves its work so far (time-based mode)
FAILURE     per-attempt doom (paper mode) or node(s) going down (time mode)
RECOVER     repaired nodes return; the queue drains onto them
HEARTBEAT   one poll round: replies sampled, estimates updated, drain/undrain
COMPLETE    an attempt finishes; capacity frees; chained jobs submit
=========== ===============================================================

**Two failure layers**, usable together:

* ``attempt_failures`` — the paper's per-attempt scenario model
  (:class:`~repro_torch.cluster.failures.FailureModel`): at each attempt start
  a failed set is sampled for that attempt only; if the job's endpoints
  or routes touch it, the attempt is doomed and charged exactly as
  :func:`repro_torch.sim.batchsim.run_batch` charges it (full remaining runtime
  without checkpointing; work-since-last-checkpoint plus write overhead
  with it).  With serial arrivals and a fixed per-batch placement this
  reproduces ``run_batch`` completion times *bit-for-bit* — the RNG draw
  order is identical (see ``tests/test_torch_sim.py``).
* ``failure_process`` — time-based node lifecycles: FAILURE/RECOVER heap
  events from pre-generated traces.  A node failure aborts every running
  job whose placement holds it (endpoint fault form — see
  ``docs/SIMULATOR.md`` for why routes are only consulted in the
  per-attempt model); the scheduler re-places the survivors or requeues
  jobs the surviving capacity cannot hold.

**State ownership.**  Who knows what about node health is deliberately
split (see ``docs/ARCHITECTURE.md``): the *simulator* owns ground truth
(``_down_count`` — how many overlapping outages hold each node down —
plus ``registry.true_outage_p`` flakiness), the *failure layers* own the
injection processes, and the *scheduler* owns the single **belief**
artifact every placement consumes — a versioned
:class:`~repro_torch.core.state.ClusterState` snapshot merged from registry
lifecycle and heartbeat estimates (``Scheduler.cluster_state()``).  The
simulator never hands truth to the mapper; it only shapes the heartbeat
replies the estimator sees.  Epochs advance only when the belief
actually changes, so long stretches of simulated time reuse one set of
engine caches.

Units: all times are simulated **seconds** on one clock from 0.0.  All
randomness flows through the single ``rng`` handed to :class:`ClusterSim`
(attempt dooms, checkpoint abort points, heartbeat replies), so a run is
a pure function of (job stream, cluster state, seed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.cluster.failures import FailureModel, FailureProcess
from repro_torch.cluster.scheduler import Job, JobRecord, Scheduler
from repro_torch.sim.events import EventQueue, EventType
from repro_torch.sim.jobsim import successful_runtime
from repro_torch.workloads.arrivals import JobSpec


@dataclasses.dataclass
class SimConfig:
    """Knobs of one simulation run (all times in simulated seconds)."""

    heartbeat_interval: Optional[float] = None   # None = no heartbeat events
    checkpoint_interval: Optional[float] = None  # None = no checkpointing
    checkpoint_overhead: float = 0.0             # wall cost per ckpt write
    restart_delay: float = 0.0                   # relaunch latency per restart
    max_attempts: int = 100                      # per job, as in run_batch
    max_events: int = 500_000                    # hard event budget
    failure_horizon: Optional[float] = None      # trace length for processes
    trace: bool = False                          # keep an event trace


@dataclasses.dataclass
class _SimJob:
    """Internal per-job state (exposed summarised as :class:`JobStats`)."""

    idx: int
    spec: JobSpec
    rec: Optional[JobRecord] = None      # scheduler-managed jobs only
    state: str = "waiting"               # waiting|queued|running|done
    placement: Optional[np.ndarray] = None
    t_ok: float = 0.0                    # runtime under current placement
    remaining: float = 0.0               # work left, seconds @ current plcmt
    ckpt_in_attempt: float = 0.0         # work preserved within this attempt
    n_ckpts: int = 0                     # paper-mode success-charge count
    epoch: int = 0                       # invalidates stale heap events
    attempts: int = 0
    aborts: int = 0
    submit_time: float = -1.0
    first_start: float = -1.0
    finish_time: float = -1.0


@dataclasses.dataclass
class JobStats:
    name: str
    policy: str
    n_ranks: int
    submit_time: float
    first_start: float
    finish_time: float
    attempts: int
    aborts: int
    requeues: int

    @property
    def completion_time(self) -> float:
        """Sojourn: submit -> finish (queue wait + restarts included)."""
        return self.finish_time - self.submit_time

    @property
    def queue_wait(self) -> float:
        return self.first_start - self.submit_time


@dataclasses.dataclass
class SimResult:
    jobs: list[JobStats]
    makespan: float                 # last finish (clock starts at 0)
    n_events: int
    node_failures: int
    truncated: bool                 # hit max_events before all jobs finished
    trace: list[tuple[float, str, str]]
    place_time_s: float = 0.0       # mapper wall-clock the scheduler spent
                                    # placing/re-placing this run's jobs
                                    # (0 for fixed-placement streams)

    @property
    def finished_jobs(self) -> list[JobStats]:
        return [j for j in self.jobs if j.finish_time >= 0]

    @property
    def mean_completion(self) -> float:
        """Mean sojourn over *finished* jobs (unfinished jobs of a
        truncated run carry -1 sentinels and are excluded); 0.0 when
        nothing finished."""
        done = self.finished_jobs
        return float(np.mean([j.completion_time for j in done])) \
            if done else 0.0

    @property
    def mean_queue_wait(self) -> float:
        started = [j for j in self.jobs if j.first_start >= 0]
        return float(np.mean([j.queue_wait for j in started])) \
            if started else 0.0

    @property
    def aborted_attempts(self) -> int:
        return int(sum(j.aborts for j in self.jobs))


class ClusterSim:
    """One simulation: a job stream against one scheduler + cluster."""

    def __init__(
        self,
        scheduler: Scheduler,
        jobs: Sequence[JobSpec],
        *,
        attempt_failures: Optional[FailureModel] = None,
        failure_process: Optional[FailureProcess] = None,
        config: Optional[SimConfig] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.sch = scheduler
        self.net = scheduler.net
        self.cfg = config or SimConfig()
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.attempt_failures = attempt_failures
        self.failure_process = failure_process
        if failure_process is not None and not self.cfg.failure_horizon:
            raise ValueError(
                "failure_process needs config.failure_horizon > 0 "
                "(trace generation bound)")
        self.jobs = [_SimJob(i, spec) for i, spec in enumerate(jobs)]
        if failure_process is not None and any(
                s.fixed_placement is not None for s in jobs):
            raise ValueError(
                "fixed_placement streams model the paper protocol and do "
                "not interact with time-based node failures; use the "
                "scheduler-placed path instead")
        # serial chaining: spec i with after_previous submits when i-1 ends
        self._chain: dict[int, int] = {
            i - 1: i for i, s in enumerate(jobs) if s.after_previous}
        if self.jobs and self.jobs[0].spec.after_previous:
            raise ValueError("first job of a stream cannot chain")
        self._by_slurm: dict[int, _SimJob] = {}
        self._down_count = np.zeros(scheduler.topo.n_nodes, dtype=np.int64)
        self._place_time_t0 = scheduler.place_time_s   # shared-scheduler base
        self._done = 0
        self._node_failures = 0        # actual up -> down transitions
        self._trace: list[tuple[float, str, str]] = []

    # ----------------------------------------------------------------- run
    def run(self) -> SimResult:
        Q = self.Q = EventQueue()
        for j in self.jobs:
            if not j.spec.after_previous:
                Q.push(j.spec.submit_time, EventType.SUBMIT, job=j.idx)
        if self.failure_process is not None:
            for ev in self.failure_process.generate(
                    self.rng, self.cfg.failure_horizon):
                kind = (EventType.FAILURE if ev.kind == "fail"
                        else EventType.RECOVER)
                Q.push(ev.time, kind, nodes=np.asarray(ev.nodes,
                                                       dtype=np.int64))
        if self.cfg.heartbeat_interval:
            Q.push(self.cfg.heartbeat_interval, EventType.HEARTBEAT)

        truncated = False
        dispatch = {
            EventType.SUBMIT: self._on_submit,
            EventType.START: self._on_start,
            EventType.CHECKPOINT: self._on_checkpoint,
            EventType.COMPLETE: self._on_complete,
            EventType.FAILURE: self._on_failure,
            EventType.RECOVER: self._on_recover,
            EventType.HEARTBEAT: self._on_heartbeat,
        }
        while Q and self._done < len(self.jobs):
            if Q.popped >= self.cfg.max_events:
                truncated = True
                break
            ev = Q.pop()
            # the scheduler's admission-latency counters read this clock
            self.sch.clock = ev.time
            if self.cfg.trace:
                self._trace.append((ev.time, ev.type.name, repr(ev.data)))
            dispatch[ev.type](ev)

        stats = [JobStats(
            name=j.spec.label(), policy=j.spec.policy,
            n_ranks=j.spec.workload.n_ranks,
            submit_time=j.submit_time, first_start=j.first_start,
            finish_time=j.finish_time, attempts=j.attempts, aborts=j.aborts,
            requeues=(j.rec.requeues if j.rec is not None else 0),
        ) for j in self.jobs]
        finished = [s.finish_time for s in stats if s.finish_time >= 0]
        return SimResult(
            jobs=stats,
            makespan=max(finished) if finished else 0.0,
            n_events=Q.popped,
            node_failures=self._node_failures,
            truncated=truncated or self._done < len(self.jobs),
            trace=self._trace,
            place_time_s=self.sch.place_time_s - self._place_time_t0,
        )

    # ------------------------------------------------------------ handlers
    def _on_submit(self, ev) -> None:
        j = self.jobs[ev["job"]]
        j.submit_time = ev.time
        if j.spec.fixed_placement is not None:
            j.placement = np.asarray(j.spec.fixed_placement, dtype=np.int64)
            self._start_running(ev.time, j,
                                successful_runtime(j.spec.workload,
                                                   j.placement, self.net))
            return
        job = Job(j.spec.workload, distribution=j.spec.policy)
        j.rec = self.sch.enqueue(job)
        j.state = "queued"
        self._by_slurm[job.job_id] = j
        self._handle_started(ev.time, self.sch.schedule_pending())

    def _handle_started(self, t: float, records: list[JobRecord]) -> None:
        for rec in records:
            j = self._by_slurm[rec.job.job_id]
            self._start_running(t, j, rec.runtime,
                                np.asarray(rec.placement.placement,
                                           dtype=np.int64))

    def _start_running(self, t: float, j: _SimJob, t_ok: float,
                       placement: Optional[np.ndarray] = None) -> None:
        """(Re)entry to the running state: rescale remaining work to the
        new placement's runtime, then begin an attempt.  Restarts (a
        requeued job coming back from the queue) pay ``restart_delay``,
        like the incremental re-place path does."""
        restart = j.t_ok > 0
        if placement is not None:
            j.placement = placement
        if restart:             # preserve the work fraction done
            j.remaining = j.remaining * (t_ok / j.t_ok)
        else:                   # fresh job
            j.remaining = t_ok
            ci = self.cfg.checkpoint_interval
            j.n_ckpts = int(t_ok // ci) if ci else 0
        j.t_ok = t_ok
        j.state = "running"
        if j.first_start < 0:
            j.first_start = t
        self._begin_attempt(t + (self.cfg.restart_delay if restart else 0.0),
                            j)

    def _begin_attempt(self, t: float, j: _SimJob) -> None:
        j.attempts += 1
        j.epoch += 1
        j.ckpt_in_attempt = 0.0
        R = j.remaining
        ci = self.cfg.checkpoint_interval
        ov = self.cfg.checkpoint_overhead
        if self.attempt_failures is not None:
            # paper mode — mirror run_batch's accounting and RNG order
            # exactly: sample the attempt's failed set, then (only on the
            # abort path, with checkpointing) the uniform abort point
            failed = self.attempt_failures.sample_failed(self.rng, R)
            doomed = (len(failed) > 0
                      and j.attempts < self.cfg.max_attempts
                      and self.net.touches_failed(j.spec.workload.comm,
                                                  j.placement, failed))
            combined = bool(ci) and self.failure_process is not None
            if doomed:
                if ci is None:
                    # full successful runtime charged, restart from scratch
                    dur, new_remaining = R, R
                else:
                    fail_at = self.rng.uniform(0.0, R)
                    n_kept = int(fail_at // ci)
                    kept = n_kept * ci
                    dur = fail_at + n_kept * ov
                    new_remaining = R - kept
                self.Q.push(t + dur, EventType.FAILURE, job=j.idx,
                            epoch=j.epoch, remaining=new_remaining)
                if combined:
                    # a node FAILURE can interrupt before the doom fires;
                    # track checkpoints on the heap so it only loses work
                    # since the last one
                    self._push_checkpoints(t, j, R, ci, ov)
            elif combined:
                # charge write overhead for this attempt's actual
                # checkpoints — after a node-failure restart, R < t_ok and
                # the initial n_ckpts count would overcharge
                n_full = self._push_checkpoints(t, j, R, ci, ov)
                self.Q.push(t + R + n_full * ov, EventType.COMPLETE,
                            job=j.idx, epoch=j.epoch)
            else:
                # pure paper mode: run_batch parity — a successful attempt
                # pays the full-runtime checkpoint count as one lump
                self.Q.push(t + R + j.n_ckpts * ov, EventType.COMPLETE,
                            job=j.idx, epoch=j.epoch)
            return
        # time-based mode: periodic checkpoints, completion after the last
        n_full = self._push_checkpoints(t, j, R, ci, ov) if ci else 0
        self.Q.push(t + R + n_full * ov, EventType.COMPLETE,
                    job=j.idx, epoch=j.epoch)

    def _push_checkpoints(self, t: float, j: _SimJob, R: float,
                          ci: float, ov: float) -> int:
        """Schedule this attempt's CHECKPOINT events (one per full
        interval strictly inside ``R``, each write costing ``ov`` wall
        time); returns how many were scheduled."""
        n_full = max(0, int(np.ceil(R / ci)) - 1)
        for k in range(1, n_full + 1):
            self.Q.push(t + k * ci + k * ov, EventType.CHECKPOINT,
                        job=j.idx, epoch=j.epoch, work=k * ci)
        return n_full

    def _valid(self, ev, j: _SimJob) -> bool:
        return j.state == "running" and ev["epoch"] == j.epoch

    def _on_start(self, ev) -> None:
        j = self.jobs[ev["job"]]
        if not self._valid(ev, j):
            return
        self._begin_attempt(ev.time, j)

    def _on_checkpoint(self, ev) -> None:
        j = self.jobs[ev["job"]]
        if self._valid(ev, j):
            j.ckpt_in_attempt = ev["work"]

    def _on_complete(self, ev) -> None:
        j = self.jobs[ev["job"]]
        if not self._valid(ev, j):
            return
        j.state = "done"
        j.finish_time = ev.time
        j.remaining = 0.0
        self._done += 1
        if j.rec is not None:
            self._handle_started(ev.time,
                                 self.sch.complete(j.rec.job.job_id))
        nxt = self._chain.get(j.idx)
        if nxt is not None:
            self.Q.push(ev.time, EventType.SUBMIT, job=nxt)

    def _on_failure(self, ev) -> None:
        if "job" in ev.data:                 # per-attempt doom (paper mode)
            j = self.jobs[ev["job"]]
            if not self._valid(ev, j):
                return
            j.aborts += 1
            j.remaining = ev["remaining"]    # already checkpoint-adjusted
            j.ckpt_in_attempt = 0.0
            j.epoch += 1                     # invalidate the doomed attempt
            self.Q.push(ev.time + self.cfg.restart_delay, EventType.START,
                        job=j.idx, epoch=j.epoch)
            return
        # node(s) going down (time-based mode)
        nodes = ev["nodes"]
        newly_down = nodes[self._down_count[nodes] == 0]
        self._down_count[nodes] += 1
        if not newly_down.size:
            return    # overlapping outage: nothing newly transitioned
        self._node_failures += int(newly_down.size)
        affected = self.sch.handle_node_failure(newly_down)
        for rec in affected:
            j = self._by_slurm[rec.job.job_id]
            j.aborts += 1
            # work since the last checkpoint is lost
            j.remaining = j.remaining - j.ckpt_in_attempt
            j.ckpt_in_attempt = 0.0
            j.epoch += 1
            if rec.state == "running":       # incrementally re-placed
                j.placement = np.asarray(rec.placement.placement,
                                         dtype=np.int64)
                new_t_ok = rec.runtime
                j.remaining = j.remaining * (new_t_ok / j.t_ok)
                j.t_ok = new_t_ok
                self.Q.push(ev.time + self.cfg.restart_delay,
                            EventType.START, job=j.idx, epoch=j.epoch)
            else:                            # survivors can't hold it
                j.state = "queued"
        # a requeued job's freed allocation may make room for other
        # pending jobs (the scheduler is clock-free and does not drain
        # on failures itself)
        self._handle_started(ev.time, self.sch.schedule_pending())

    def _on_recover(self, ev) -> None:
        nodes = ev["nodes"]
        self._down_count[nodes] = np.maximum(self._down_count[nodes] - 1, 0)
        newly_up = nodes[self._down_count[nodes] == 0]
        if newly_up.size:
            self._handle_started(ev.time, self.sch.recover(newly_up))

    def _on_heartbeat(self, ev) -> None:
        # NodeState plugin semantics: a DOWN node never answers; a live
        # node misses a round with its ground-truth flakiness probability
        true_p = self.sch.registry.true_outage_vector()
        replies = (self._down_count == 0) \
            & (self.rng.random(len(true_p)) >= true_p)
        self._handle_started(ev.time, self.sch.heartbeat_round(
            replies, dt=self.cfg.heartbeat_interval))
        if self._done < len(self.jobs):
            self.Q.push(ev.time + self.cfg.heartbeat_interval,
                        EventType.HEARTBEAT)
