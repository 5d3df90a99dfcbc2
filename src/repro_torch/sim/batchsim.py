"""Batch simulation — the paper's Section 5.2 experiment engine.

A *batch* is 100 instances of the same MPI application (paper).  Per batch:
a candidate faulty set ``N_f`` is fixed; per instance, each candidate enters
the failed state independently with ``p_f``.  A failed node kills any job
whose endpoints or routes touch it.  Without checkpointing (paper
assumption), every abort charges one full successful runtime and the
instance restarts from scratch:

    T_batch = sum_i T_success * (1 + aborts_i)
    abort_ratio = (# instances with >= 1 abort) / instances     [paper]
    abort_rate  = aborted attempts / total attempts             [diagnostic]

``checkpoint_interval`` enables the beyond-paper checkpoint/restart model:
an aborted attempt only charges the work since the last checkpoint plus
checkpoint-write overhead, bounding the restart cost.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cluster.failures import FailureModel
from repro_torch.core.engine import PlacementEngine, PlacementRequest
from repro_torch.core.state import ClusterState
from repro_torch.core.topology import TorusTopology
from repro_torch.sim.jobsim import simulate_instance, successful_runtime
from repro_torch.sim.network import TorusNetwork
from repro_torch.workloads.patterns import Workload


@dataclasses.dataclass
class BatchResult:
    policy: str
    completion_time: float
    abort_ratio: float          # paper metric: instances aborted >= once
    abort_rate: float           # attempts aborted / attempts
    n_instances: int
    n_aborted_attempts: int
    success_runtime: float      # per-instance successful runtime
    placement: np.ndarray
    faulty_nodes_used: int
    place_time_s: float = 0.0   # mapper wall-clock for this batch's placement


def run_batch(
    wl: Workload,
    policy: str,
    net: TorusNetwork,
    failure_model: FailureModel,
    known_p_f: np.ndarray | None,
    n_instances: int = 100,
    rng: np.random.Generator | None = None,
    checkpoint_interval: float | None = None,
    checkpoint_overhead: float = 0.0,
    max_attempts: int = 100,
    engine: PlacementEngine | None = None,
    device: str | None = None,
) -> BatchResult:
    """Simulate one batch under one placement policy.

    **The ``known_p_f`` contract** (truth vs estimate): the placement
    policy only ever sees ``known_p_f`` — what the scheduler *believes*,
    i.e. a heartbeat-derived estimate — while ``failure_model`` holds the
    ground truth used to sample actual failures.  Passing
    ``failure_model.outage_vector(...)`` models a perfectly converged
    estimator (the paper's setting); passing a
    :meth:`~repro_torch.cluster.heartbeat.HeartbeatMonitor.outage_probabilities`
    vector models imperfect knowledge (see the reference package's
    ``benchmarks/fault_ablation``);
    passing ``None`` models a fault-blind scheduler.  Eq. 1 only consults
    ``p_f > 0``, so any estimator that flags the right *set* of nodes is
    as good as the truth.

    Placement is computed once per batch, as in the paper (N_f is fixed
    per batch).  Pass a shared ``engine`` to reuse cached hop/weight
    matrices across batches and policies instead of recomputing full
    topology state per job.  ``rng`` drives both the per-attempt failure
    draws and any stochastic policy; one batch is a pure function of
    (workload, policy, rng state).  Without an ``engine`` one is built on
    ``device``: ``cuda`` when omitted, which raises
    :class:`~repro_torch.core.backend.BackendUnavailableError` without a
    GPU; ``device="cpu"`` runs the plain PyTorch kernels.  The placement
    comes back as a host ``int64`` array; the failure draws and the
    network model stay host NumPy.
    """
    rng = rng or np.random.default_rng(0)
    topo = net.topo
    engine = engine or PlacementEngine(device=device)
    # the belief travels as a versioned ClusterState; from_arrays interns
    # by content, so every batch sharing one N_f shares one epoch (and
    # the engine's epoch-keyed weight matrices)
    state = ClusterState.from_arrays(topo.n_nodes, p_f=known_p_f)
    req = PlacementRequest(comm=wl.comm, topology=topo, state=state)
    res = engine.place(req, policy=policy, rng=rng)
    placement = res.placement
    t_ok = successful_runtime(wl, placement, net)

    total_time = 0.0
    aborted_instances = 0
    aborted_attempts = 0
    n_ckpts = int(t_ok // checkpoint_interval) if checkpoint_interval else 0
    for _ in range(n_instances):
        attempts = 0
        remaining = t_ok
        while True:
            attempts += 1
            failed = failure_model.sample_failed(rng, remaining)
            out = simulate_instance(wl, placement, net, failed,
                                    runtime=remaining)
            if out.completed or attempts >= max_attempts:
                # successful attempt pays checkpoint-write overhead too
                total_time += remaining + n_ckpts * checkpoint_overhead
                break
            aborted_attempts += 1
            if checkpoint_interval is None:
                # paper accounting: a full successful runtime is charged per
                # abort, then the job restarts from scratch
                total_time += t_ok
                remaining = t_ok
            else:
                # beyond paper: abort at a uniform point of the attempt;
                # work up to the last checkpoint is preserved (n_kept
                # writes were performed and are charged)
                fail_at = rng.uniform(0.0, remaining)
                n_kept = int(fail_at // checkpoint_interval)
                kept = n_kept * checkpoint_interval
                total_time += fail_at + n_kept * checkpoint_overhead
                remaining = remaining - kept
        if attempts > 1:
            aborted_instances += 1
    attempts_total = n_instances + aborted_attempts
    return BatchResult(
        policy=policy,
        completion_time=total_time,
        abort_ratio=aborted_instances / n_instances,
        abort_rate=aborted_attempts / attempts_total,
        n_instances=n_instances,
        n_aborted_attempts=aborted_attempts,
        success_runtime=t_ok,
        placement=placement,
        faulty_nodes_used=res.faulty_nodes_used,
        place_time_s=res.wall_time_s,
    )


@dataclasses.dataclass
class ScenarioResult:
    policy: str
    batches: list
    mean_completion: float
    mean_abort_ratio: float
    mean_place_time_s: float = 0.0  # placement overhead per batch (Section 5:
                                    # must stay negligible vs completion_time)

    def improvement_over(self, other: "ScenarioResult") -> float:
        return 1.0 - self.mean_completion / other.mean_completion


def run_scenario(
    wl_factory,
    policies,
    dims: tuple[int, ...] = (8, 8, 8),
    n_batches: int = 10,
    n_instances: int = 100,
    n_faulty: int = 16,
    p_f: float = 0.02,
    seed: int = 0,
    scheduler_knows_truth: bool = True,
    topology=None,
    network=None,
    device: str | None = None,
    **net_kw,
) -> dict[str, ScenarioResult]:
    """The full Fig. 4/5 protocol: ``n_batches`` batches x ``n_instances``
    instances; per batch a fresh random N_f (shared by all policies so the
    comparison is paired).

    Hosts: pass ``topology`` (any :class:`~repro_torch.core.engine.Topology`
    implementation — fat-tree, dragonfly, ...) to run on a non-torus
    platform; ``dims`` is the legacy torus shorthand used when ``topology``
    is omitted.  ``network`` overrides the performance model (default: the
    best in-tree model for the topology, see
    :func:`repro_torch.sim.network.network_for`).  The scenario's engine
    runs on ``device`` (``cuda`` when omitted; see :func:`run_batch`).
    """
    from repro_torch.cluster.failures import BernoulliPerJob
    from repro_torch.sim.network import network_for

    topo = topology if topology is not None else TorusTopology(dims)
    net = network if network is not None else network_for(topo, **net_kw)
    # one engine for the whole scenario: the torus hop matrix is derived
    # once, and each batch's Eq. 1 weight matrix once (shared by policies)
    engine = PlacementEngine(device=device)
    results: dict[str, list[BatchResult]] = {p: [] for p in policies}
    for b in range(n_batches):
        batch_rng = np.random.default_rng(seed * 1000 + b)
        candidates = batch_rng.choice(topo.n_nodes, n_faulty, replace=False)
        fm = BernoulliPerJob(candidates, p_f)
        known = fm.outage_vector(topo.n_nodes) if scheduler_knows_truth else None
        wl = wl_factory()
        for pol in policies:
            r = run_batch(wl, pol, net, fm, known, n_instances=n_instances,
                          rng=np.random.default_rng(seed * 7777 + b),
                          engine=engine)
            results[pol].append(r)
    out = {}
    for pol in policies:
        rs = results[pol]
        out[pol] = ScenarioResult(
            policy=pol,
            batches=rs,
            mean_completion=float(np.mean([r.completion_time for r in rs])),
            mean_abort_ratio=float(np.mean([r.abort_ratio for r in rs])),
            mean_place_time_s=float(np.mean([r.place_time_s for r in rs])),
        )
    return out
