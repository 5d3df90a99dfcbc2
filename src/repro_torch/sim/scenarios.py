"""Named scenario presets for the event-driven cluster simulator.

Each preset assembles a full experiment — topology, network model, job
stream, failure layer, scheduler knobs — and runs it once per placement
policy so the comparison is paired (same seeds, same traces).  Presets
are registered in :data:`SCENARIOS`; run one with::

    from repro_torch.sim.scenarios import run_preset
    out = run_preset("saturated-queue", policies=("linear", "tofa"), seed=0)

Every preset builds its :class:`~repro_torch.core.engine.PlacementEngine`
on ``device`` (``cuda`` when omitted, which raises
:class:`~repro_torch.core.backend.BackendUnavailableError` without a GPU;
``device="cpu"`` runs the plain PyTorch kernels).  The presets that take
``engine=`` use the caller's engine instead.  The event logic, network
model and failure draws stay host NumPy, driven by the same RNG streams
as the reference package's presets, so every result field except the
wall-clock ``place_time_s`` equals the reference's bit for bit.

Every preset returns ``{"name", "params", "policies": {policy: row}}``
where a row carries ``mean_completion``, ``makespan``,
``aborted_attempts``, ``mean_queue_wait``, ``n_events`` and
``node_failures`` (see :class:`~repro_torch.sim.clustersim.SimResult`).
``fast=True`` shrinks every preset to a seconds-scale smoke run (CI).

The ``paper-fig4-5`` preset reproduces the paper's Section 5.2 protocol
as a special case of the event simulator — serial arrivals, placement
computed once per batch, per-batch Bernoulli ``N_f`` — with the *same
RNG draw order* as :func:`repro_torch.sim.batchsim.run_batch`, so its
completion times match the closed-form engine bit-for-bit (asserted in
``tests/test_torch_sim.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.cluster.failures import (BernoulliPerJob, CascadingOutages,
                                    CompositeProcess, CorrelatedOutages,
                                    ExponentialLifetimes, MaintenanceWindow,
                                    contiguous_racks)
from repro_torch.cluster.nodes import NodeState
from repro_torch.cluster.scheduler import Scheduler
from repro_torch.core.dragonfly import DragonflyTopology
from repro_torch.core.engine import PlacementEngine, PlacementRequest
from repro_torch.core.fattree import FatTreeTopology
from repro_torch.core.state import ClusterState
from repro_torch.core.topology import TorusTopology
from repro_torch.sim.clustersim import ClusterSim, SimConfig, SimResult
from repro_torch.sim.network import network_for
from repro_torch.workloads.arrivals import (burst_stream, mixed_size_factory,
                                      poisson_stream, serial_stream)
from repro_torch.workloads.patterns import npb_dt_like


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    fn: Callable


SCENARIOS: dict[str, Preset] = {}


def register_preset(name: str, description: str):
    def deco(fn):
        SCENARIOS[name] = Preset(name, description, fn)
        return fn
    return deco


def list_presets() -> list[Preset]:
    return list(SCENARIOS.values())


def run_preset(name: str, **kw) -> dict:
    """Run the preset ``name``; ``kw`` (``policies``, ``seed``, ``fast``,
    ``device``, ...) goes to its function."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name].fn(**kw)


def _row(res: SimResult) -> dict:
    return {
        "mean_completion": res.mean_completion,
        "makespan": res.makespan,
        "aborted_attempts": res.aborted_attempts,
        "mean_queue_wait": res.mean_queue_wait,
        "n_events": res.n_events,
        "node_failures": res.node_failures,
        "truncated": res.truncated,
        "place_time_s": res.place_time_s,
    }


def _converged_monitor(sch: Scheduler, truth: np.ndarray, seed: int,
                       rounds: int = 400) -> None:
    """Warm the heartbeat estimator to convergence on the ground truth —
    the `known_p_f` contract's 'perfect estimator' end (the paper's
    setting).  In-sim HEARTBEAT events keep it fresh afterwards."""
    sch.registry.set_outage_probabilities(np.flatnonzero(truth > 0),
                                          float(truth.max()))
    sch.monitor.simulate_rounds(np.random.default_rng(seed ^ 0x5eed),
                                truth, rounds)


BELIEF_MODES = ("monitor", "oracle", "learned", "learned-node", "static",
                "adversarial")


def _attach_belief(sch: Scheduler, mode: str, proc, groups, seed: int, *,
                   horizon: float = 1.0,
                   train_horizon: Optional[float] = None,
                   fast: bool = False) -> dict:
    """Attach a belief tracker to ``sch`` per the preset's ``belief_mode``.

    The belief-error axis of the reference package's
    ``benchmarks/belief_sweep.py``:

    * ``"monitor"`` (default) — no tracker; the scheduler keeps reading
      the converged heartbeat estimate.  Bit-identical to the pre-belief
      presets.
    * ``"oracle"`` — the failure process's :meth:`expected_p_f` handed
      straight to placement (zero belief error).
    * ``"learned"`` — :class:`~repro_torch.beliefs.RackPooledBayes` pre-trained
      on a ``train_horizon``-long trace generated from a seed-derived
      training RNG (disjoint from every sim stream), then updated online
      from the live failure/repair events.  ``"learned-node"`` is the
      un-pooled :class:`~repro_torch.beliefs.ExponentialBayes` ablation.
    * ``"static"`` — a uniform positive prior (mean of the truth's
      nonzero entries): under the Eq. 1 ``p_f > 0`` pattern this
      penalizes every route equally, i.e. fault-*blind* placement — the
      baseline a learned belief must beat.
    * ``"adversarial"`` — the truth vector reversed in id order: belief
      mass on healthy nodes, none on the flaky set.

    Drain/degrade decisions stay monitor-driven in every mode, so the
    only thing that varies across modes is the belief Eq. 1 consumes.
    Returns belief-quality scalars for the result row (empty for
    ``"monitor"``).
    """
    if mode == "monitor":
        return {}
    from repro_torch.beliefs import (AdversarialBeliefs, BeliefTracker,
                               ExponentialBayes, OracleBeliefs,
                               RackPooledBayes, StaticPrior, belief_mse,
                               pattern_confusion)
    n = sch.topo.n_nodes
    truth = proc.expected_p_f(n)
    if mode == "oracle":
        model = OracleBeliefs(truth)
    elif mode == "static":
        pos = truth[truth > 0]
        model = StaticPrior(float(pos.mean()) if pos.size else 0.1)
    elif mode == "adversarial":
        model = AdversarialBeliefs(truth)
    elif mode == "learned":
        model = RackPooledBayes([np.asarray(g) for g in groups])
    elif mode == "learned-node":
        model = ExponentialBayes()
    else:
        raise ValueError(f"unknown belief_mode {mode!r}; "
                         f"have {BELIEF_MODES}")
    tracker = BeliefTracker(n, model, horizon=horizon)
    if mode in ("learned", "learned-node"):
        if train_horizon is None:
            train_horizon = 60.0 if fast else 240.0
        rng_train = np.random.default_rng(seed * 9901 + 97)
        tracker.ingest_events(proc.generate(rng_train, train_horizon),
                              t_end=train_horizon)
        tracker.rebase(0.0)
    sch.tracker = tracker
    p0 = tracker.p_f_vector(now=0.0)
    pat = pattern_confusion(p0, truth)
    return {"belief_err": belief_mse(p0, truth),
            "belief_pattern_precision": pat["precision"],
            "belief_pattern_recall": pat["recall"]}


# ---------------------------------------------------------------- presets
@register_preset(
    "paper-fig4-5",
    "The paper's Section 5.2 protocol through the event simulator: serial "
    "arrivals, one placement per batch, per-batch Bernoulli N_f; matches "
    "batchsim.run_scenario bit-for-bit.")
def paper_fig4_5(policies: Sequence[str] = ("linear", "tofa"),
                 seed: int = 0, fast: bool = False,
                 wl_factory: Optional[Callable] = None,
                 dims: tuple[int, ...] = (8, 8, 8),
                 n_batches: int = 10, n_instances: int = 100,
                 n_faulty: int = 16, p_f: float = 0.02,
                 scheduler_knows_truth: bool = True,
                 topology=None,
                 device: Optional[str] = None) -> dict:
    if fast:
        dims, n_batches, n_instances, n_faulty = (4, 4, 4), 2, 20, 8
        wl_factory = wl_factory or (lambda: npb_dt_like(24))
    wl_factory = wl_factory or (lambda: npb_dt_like(85))
    topo = topology if topology is not None else TorusTopology(dims)
    net = network_for(topo)
    engine = PlacementEngine(device=device)
    per_batch: dict[str, list[SimResult]] = {p: [] for p in policies}
    place_time: dict[str, float] = {p: 0.0 for p in policies}
    for b in range(n_batches):
        # identical draw structure to batchsim.run_scenario: candidates
        # from the batch RNG, one attempt/placement RNG per (batch, policy)
        batch_rng = np.random.default_rng(seed * 1000 + b)
        candidates = batch_rng.choice(topo.n_nodes, n_faulty, replace=False)
        fm = BernoulliPerJob(candidates, p_f)
        known = (fm.outage_vector(topo.n_nodes)
                 if scheduler_knows_truth else None)
        wl = wl_factory()
        known_state = ClusterState.from_arrays(topo.n_nodes, p_f=known)
        for pol in policies:
            rng = np.random.default_rng(seed * 7777 + b)
            plan = engine.place(
                PlacementRequest(comm=wl.comm, topology=topo,
                                 state=known_state),
                policy=pol, rng=rng)
            place_time[pol] += plan.wall_time_s
            sch = Scheduler(topo, net=net, engine=engine)
            sim = ClusterSim(
                sch,
                serial_stream([wl] * n_instances, policy=pol,
                              fixed_placement=plan.placement),
                attempt_failures=fm, rng=rng)
            per_batch[pol].append(sim.run())
    rows = {}
    for pol in policies:
        rs = per_batch[pol]
        rows[pol] = {
            "mean_completion": float(np.mean([r.makespan for r in rs])),
            "batch_completions": [r.makespan for r in rs],
            "aborted_attempts": int(sum(r.aborted_attempts for r in rs)),
            "n_events": int(sum(r.n_events for r in rs)),
            "place_time_s": place_time[pol],
        }
    return {"name": "paper-fig4-5",
            "params": {"dims": getattr(topo, "dims", None),
                       "n_batches": n_batches, "n_instances": n_instances,
                       "n_faulty": n_faulty, "p_f": p_f, "seed": seed},
            "policies": rows}


def _flaky_cluster(topo, net, engine, seed: int, candidates, p_f: float
                   ) -> tuple[Scheduler, BernoulliPerJob]:
    """A cluster with a known flaky set: Bernoulli per-attempt failures,
    heartbeat estimator pre-converged on the truth."""
    fm = BernoulliPerJob(np.asarray(candidates), p_f)
    sch = Scheduler(topo, net=net, engine=engine, seed=seed)
    _converged_monitor(sch, fm.outage_vector(topo.n_nodes), seed)
    return sch, fm


@register_preset(
    "saturated-queue",
    "Every job submitted at t=0 against bounded capacity: queueing, "
    "backfill and abort rework dominate the makespan.")
def saturated_queue(policies: Sequence[str] = ("linear", "tofa"),
                    seed: int = 0, fast: bool = False,
                    device: Optional[str] = None) -> dict:
    dims = (4, 4, 4) if fast else (8, 8, 8)
    n_jobs = 12 if fast else 48
    n_flaky = 16 if fast else 96
    p_f = 0.3
    topo = TorusTopology(dims)
    net = network_for(topo)
    engine = PlacementEngine(device=device)
    rng0 = np.random.default_rng(seed * 101 + 7)
    candidates = rng0.choice(topo.n_nodes, n_flaky, replace=False)
    factory = mixed_size_factory(sizes=(8, 12, 18) if fast
                                 else (16, 27, 64))
    wls = [factory(np.random.default_rng(seed * 31 + i))
           for i in range(n_jobs)]
    rows = {}
    for pol in policies:
        sch, fm = _flaky_cluster(topo, net, engine, seed, candidates, p_f)
        sim = ClusterSim(
            sch, burst_stream(wls, policy=pol), attempt_failures=fm,
            config=SimConfig(heartbeat_interval=0.5),
            rng=np.random.default_rng(seed * 997 + 13))
        rows[pol] = _row(sim.run())
    return {"name": "saturated-queue",
            "params": {"dims": dims, "n_jobs": n_jobs, "n_flaky": n_flaky,
                       "p_f": p_f, "seed": seed},
            "policies": rows}


@register_preset(
    "mixed-stream",
    "Open Poisson arrivals of a mixed-width job stream — steady-state "
    "sojourn time and queue wait per policy.")
def mixed_stream(policies: Sequence[str] = ("linear", "tofa"),
                 seed: int = 0, fast: bool = False,
                 device: Optional[str] = None) -> dict:
    dims = (4, 4, 4) if fast else (8, 8, 8)
    n_jobs = 15 if fast else 60
    rate = 8.0          # jobs/second: comfortably above service capacity
    topo = TorusTopology(dims)
    net = network_for(topo)
    engine = PlacementEngine(device=device)
    rng0 = np.random.default_rng(seed * 211 + 3)
    candidates = rng0.choice(topo.n_nodes,
                             16 if fast else 96, replace=False)
    stream_rng = np.random.default_rng(seed * 47 + 1)
    jobs = poisson_stream(mixed_size_factory(sizes=(8, 12) if fast
                                             else (16, 27, 64)),
                          rate=rate, n_jobs=n_jobs, rng=stream_rng)
    rows = {}
    for pol in policies:
        for spec in jobs:
            spec.policy = pol
        sch, fm = _flaky_cluster(topo, net, engine, seed, candidates, 0.25)
        sim = ClusterSim(
            sch, jobs, attempt_failures=fm,
            config=SimConfig(heartbeat_interval=0.5),
            rng=np.random.default_rng(seed * 613 + 5))
        rows[pol] = _row(sim.run())
    return {"name": "mixed-stream",
            "params": {"dims": dims, "n_jobs": n_jobs, "rate": rate,
                       "seed": seed},
            "policies": rows}


@register_preset(
    "fat-tree",
    "The saturated mix on a k-ary Clos fabric instead of a torus — "
    "exercises the Topology protocol + HopNetwork end of the simulator.")
def fat_tree(policies: Sequence[str] = ("linear", "tofa"),
             seed: int = 0, fast: bool = False,
             device: Optional[str] = None) -> dict:
    k = 4 if fast else 8                      # 16 / 128 hosts
    topo = FatTreeTopology(k)
    net = network_for(topo)
    engine = PlacementEngine(device=device)
    n_jobs = 8 if fast else 24
    rng0 = np.random.default_rng(seed * 307 + 11)
    candidates = rng0.choice(topo.n_nodes,
                             max(4, topo.n_nodes // 4), replace=False)
    factory = mixed_size_factory(sizes=(4, 6) if fast else (8, 16, 32))
    wls = [factory(np.random.default_rng(seed * 59 + i))
           for i in range(n_jobs)]
    rows = {}
    for pol in policies:
        sch, fm = _flaky_cluster(topo, net, engine, seed, candidates, 0.3)
        sim = ClusterSim(
            sch, burst_stream(wls, policy=pol), attempt_failures=fm,
            config=SimConfig(heartbeat_interval=0.5),
            rng=np.random.default_rng(seed * 811 + 17))
        rows[pol] = _row(sim.run())
    return {"name": "fat-tree",
            "params": {"k": k, "n_hosts": topo.n_nodes, "n_jobs": n_jobs,
                       "seed": seed},
            "policies": rows}


@register_preset(
    "correlated-failures",
    "Time-correlated rack outages with repair: flaky racks miss heartbeats "
    "and actually go down mid-run; restarts charge from the last "
    "checkpoint and engine.replace moves the displaced processes.")
def correlated_failures(policies: Sequence[str] = ("linear", "tofa"),
                        seed: int = 0, fast: bool = False,
                        belief_mode: str = "monitor",
                        p_f_atol: Optional[float] = None,
                        train_horizon: Optional[float] = None,
                        checkpointing: bool = True,
                        engine: Optional[PlacementEngine] = None,
                        device: Optional[str] = None) -> dict:
    # full scale stays at a 216-node torus: every distinct failed set
    # costs one Eq. 1 weight-matrix derivation (route enumeration, ~1 s
    # at 6x6x6 vs ~5 s at 8x8x8), and a time-based run visits many
    dims = (4, 4, 4) if fast else (6, 6, 6)
    topo = TorusTopology(dims)
    net = network_for(topo)
    # ``engine`` lets instrumentation (the belief-sweep churn row) read
    # the cache counters; ``belief_mode`` selects the p_f source the
    # placements consume (see _attach_belief) and ``p_f_atol`` overrides
    # the scheduler's interning tolerance (None keeps its default)
    engine = (engine if engine is not None
              else PlacementEngine(device=device))
    rack_size = 16 if fast else 36
    racks = contiguous_racks(topo.n_nodes, rack_size)
    flaky_racks = racks[:1] if fast else racks[:2]
    flaky_ids = np.concatenate(flaky_racks)
    n_jobs = 10 if fast else 24
    factory = mixed_size_factory(sizes=(8, 12) if fast else (16, 27))
    wls = [factory(np.random.default_rng(seed * 83 + i))
           for i in range(n_jobs)]
    horizon = 500.0
    proc = CompositeProcess([
        CorrelatedOutages(flaky_racks, mtbf=1.0 if fast else 3.0,
                          mttr=0.3),
        ExponentialLifetimes(flaky_ids, mtbf=4.0 if fast else 12.0,
                             mttr=0.5),
    ])
    rows = {}
    for pol in policies:
        sch_kw = {} if p_f_atol is None else {"p_f_atol": p_f_atol}
        sch = Scheduler(topo, net=net, engine=engine, seed=seed,
                        drain_threshold=0.6, **sch_kw)
        truth = np.zeros(topo.n_nodes)
        truth[flaky_ids] = 0.25          # flaky racks also miss heartbeats
        _converged_monitor(sch, truth, seed)
        binfo = _attach_belief(sch, belief_mode, proc, racks, seed,
                               train_horizon=train_horizon, fast=fast)
        sim = ClusterSim(
            sch, burst_stream(wls, policy=pol), failure_process=proc,
            config=SimConfig(heartbeat_interval=0.25,
                             checkpoint_interval=(0.05 if checkpointing
                                                  else None),
                             checkpoint_overhead=(0.002 if checkpointing
                                                  else 0.0),
                             restart_delay=0.01,
                             failure_horizon=horizon),
            rng=np.random.default_rng(seed * 1213 + 29))
        rows[pol] = _row(sim.run())
        rows[pol].update(binfo)
    return {"name": "correlated-failures",
            "params": {"dims": dims, "rack_size": rack_size,
                       "n_flaky_racks": len(flaky_racks), "n_jobs": n_jobs,
                       "belief_mode": belief_mode, "seed": seed},
            "policies": rows}


@register_preset(
    "drain-sweep",
    "Sweep the drain threshold on a cluster whose flaky nodes both miss "
    "heartbeats and genuinely die: eager draining protects fault-blind "
    "policies (linear) at a capacity cost, lax draining keeps scheduling "
    "onto nodes about to fail.")
def drain_sweep(policies: Sequence[str] = ("linear", "tofa"), seed: int = 0,
                fast: bool = False,
                thresholds: Sequence[float] = (0.1, 0.5, 1.01),
                engine: Optional[PlacementEngine] = None,
                device: Optional[str] = None) -> dict:
    dims = (4, 4, 4) if fast else (6, 6, 6)     # see correlated-failures
    topo = TorusTopology(dims)
    net = network_for(topo)
    # ``engine`` lets instrumentation (the reference package's
    # benchmarks/state_churn.py) read
    # the cache counters the sweep produced
    engine = (engine if engine is not None
              else PlacementEngine(device=device))
    n_flaky = 12 if fast else 40
    rng0 = np.random.default_rng(seed * 401 + 19)
    flaky = rng0.choice(topo.n_nodes, n_flaky, replace=False)
    n_jobs = 8 if fast else 16
    factory = mixed_size_factory(sizes=(8, 12) if fast else (16, 27))
    wls = [factory(np.random.default_rng(seed * 71 + i))
           for i in range(n_jobs)]
    proc = ExponentialLifetimes(flaky, mtbf=2.0 if fast else 6.0, mttr=0.5)
    truth = np.zeros(topo.n_nodes)
    truth[flaky] = 0.3
    rows: dict = {}
    for pol in policies:
        rows[pol] = {}
        for th in thresholds:
            sch = Scheduler(topo, net=net, engine=engine, seed=seed,
                            drain_threshold=th)
            # converged estimator + heartbeats running before the burst
            # arrives at t=1.0, so draining happens ahead of placement
            _converged_monitor(sch, truth, seed)
            sim = ClusterSim(
                sch, burst_stream(wls, policy=pol, at=1.0),
                failure_process=proc,
                config=SimConfig(heartbeat_interval=0.1,
                                 checkpoint_interval=0.05,
                                 checkpoint_overhead=0.002,
                                 failure_horizon=500.0),
                rng=np.random.default_rng(seed * 1709 + 31))
            rows[pol][th] = _row(sim.run())
    return {"name": "drain-sweep",
            "params": {"dims": dims, "n_flaky": n_flaky, "n_jobs": n_jobs,
                       "thresholds": list(thresholds), "seed": seed},
            "policies": rows}


@register_preset(
    "dragonfly",
    "The saturated mix on a dragonfly (groups of all-to-all routers joined "
    "by global links) — the high-radix host family: exercises the Topology "
    "protocol + HopNetwork on a 3-level hierarchy with gateway detours.")
def dragonfly(policies: Sequence[str] = ("linear", "tofa"),
              seed: int = 0, fast: bool = False,
              device: Optional[str] = None) -> dict:
    topo = (DragonflyTopology(p=2, a=4, h=2)          # 9 groups, 72 hosts
            if fast else
            DragonflyTopology(p=4, a=8, h=4, g=9))    # 9 groups, 288 hosts
    net = network_for(topo)
    engine = PlacementEngine(device=device)
    n_jobs = 8 if fast else 24
    rng0 = np.random.default_rng(seed * 613 + 11)
    candidates = rng0.choice(topo.n_nodes,
                             max(4, topo.n_nodes // 4), replace=False)
    factory = mixed_size_factory(sizes=(4, 6) if fast else (8, 16, 32))
    wls = [factory(np.random.default_rng(seed * 67 + i))
           for i in range(n_jobs)]
    rows = {}
    for pol in policies:
        sch, fm = _flaky_cluster(topo, net, engine, seed, candidates, 0.3)
        sim = ClusterSim(
            sch, burst_stream(wls, policy=pol), attempt_failures=fm,
            config=SimConfig(heartbeat_interval=0.5),
            rng=np.random.default_rng(seed * 947 + 17))
        rows[pol] = _row(sim.run())
    return {"name": "dragonfly",
            "params": {"p": topo.p, "a": topo.a, "h": topo.h, "g": topo.g,
                       "n_hosts": topo.n_nodes, "n_jobs": n_jobs,
                       "seed": seed},
            "policies": rows}


@register_preset(
    "cascading-racks",
    "Cascading rack failures: outages on two flaky racks spread to "
    "adjacent racks by contagion — the scheduler's belief covers the "
    "seeds, but the healthy-looking neighbours fail too.  Checkpointed "
    "restarts + engine.replace under correlated, spreading faults.")
def cascading_racks(policies: Sequence[str] = ("linear", "tofa"),
                    seed: int = 0, fast: bool = False,
                    belief_mode: str = "monitor",
                    p_f_atol: Optional[float] = None,
                    train_horizon: Optional[float] = None,
                    checkpointing: bool = True,
                    engine: Optional[PlacementEngine] = None,
                    device: Optional[str] = None) -> dict:
    dims = (4, 4, 4) if fast else (6, 6, 6)   # see correlated-failures
    topo = TorusTopology(dims)
    net = network_for(topo)
    engine = (engine if engine is not None
              else PlacementEngine(device=device))
    rack_size = 16 if fast else 27
    racks = contiguous_racks(topo.n_nodes, rack_size)
    seed_racks = (0, 1)                       # spontaneous-outage racks
    proc = CascadingOutages(racks, mtbf=2.0 if fast else 6.0, mttr=0.4,
                            spread_p=0.5, spread_delay=0.05,
                            seed_groups=seed_racks)
    n_jobs = 8 if fast else 16
    factory = mixed_size_factory(sizes=(8, 12) if fast else (16, 27))
    wls = [factory(np.random.default_rng(seed * 151 + i))
           for i in range(n_jobs)]
    truth = proc.expected_p_f(topo.n_nodes)
    rows = {}
    for pol in policies:
        sch_kw = {} if p_f_atol is None else {"p_f_atol": p_f_atol}
        sch = Scheduler(topo, net=net, engine=engine, seed=seed,
                        drain_threshold=0.6, **sch_kw)
        _converged_monitor(sch, truth, seed)
        binfo = _attach_belief(sch, belief_mode, proc, racks, seed,
                               train_horizon=train_horizon, fast=fast)
        sim = ClusterSim(
            sch, burst_stream(wls, policy=pol, at=1.0),
            failure_process=proc,
            config=SimConfig(heartbeat_interval=0.25,
                             checkpoint_interval=(0.05 if checkpointing
                                                  else None),
                             checkpoint_overhead=(0.002 if checkpointing
                                                  else 0.0),
                             restart_delay=0.01,
                             failure_horizon=500.0),
            rng=np.random.default_rng(seed * 1327 + 19))
        rows[pol] = _row(sim.run())
        rows[pol].update(binfo)
    return {"name": "cascading-racks",
            "params": {"dims": dims, "rack_size": rack_size,
                       "seed_racks": list(seed_racks), "n_jobs": n_jobs,
                       "belief_mode": belief_mode, "seed": seed},
            "policies": rows}


@register_preset(
    "maintenance-burst",
    "A maintenance window takes a whole rack out of service just before "
    "an adversarial burst of wide jobs lands on the shrunken cluster; "
    "flaky nodes elsewhere keep dying.  Fault-aware placement must thread "
    "tight capacity around the elevated-p_f nodes until the rack returns.")
def maintenance_burst(policies: Sequence[str] = ("linear", "tofa"),
                      seed: int = 0, fast: bool = False,
                      belief_mode: str = "monitor",
                      p_f_atol: Optional[float] = None,
                      train_horizon: Optional[float] = None,
                      checkpointing: bool = True,
                      engine: Optional[PlacementEngine] = None,
                      device: Optional[str] = None) -> dict:
    dims = (4, 4, 4) if fast else (6, 6, 6)
    topo = TorusTopology(dims)
    net = network_for(topo)
    engine = (engine if engine is not None
              else PlacementEngine(device=device))
    rack_size = 16 if fast else 36
    racks = contiguous_racks(topo.n_nodes, rack_size)
    maintenance = racks[-1]
    n_flaky = 10 if fast else 32
    rng0 = np.random.default_rng(seed * 733 + 29)
    pool = np.setdiff1d(np.arange(topo.n_nodes), maintenance)
    flaky = rng0.choice(pool, n_flaky, replace=False)
    # adversarial burst: wide jobs only, sized against the shrunken
    # capacity, all at t=1.0 — inside the maintenance window
    n_jobs = 8 if fast else 14
    factory = mixed_size_factory(sizes=(12, 16) if fast else (27, 64))
    wls = [factory(np.random.default_rng(seed * 173 + i))
           for i in range(n_jobs)]
    proc = CompositeProcess([
        MaintenanceWindow(maintenance, start=0.5, duration=4.0),
        ExponentialLifetimes(flaky, mtbf=0.8 if fast else 2.5, mttr=0.5),
    ])
    truth = np.zeros(topo.n_nodes)
    truth[flaky] = 0.3
    rows = {}
    for pol in policies:
        sch_kw = {} if p_f_atol is None else {"p_f_atol": p_f_atol}
        sch = Scheduler(topo, net=net, engine=engine, seed=seed,
                        drain_threshold=0.6, **sch_kw)
        _converged_monitor(sch, truth, seed)
        binfo = _attach_belief(sch, belief_mode, proc, racks, seed,
                               train_horizon=train_horizon, fast=fast)
        sim = ClusterSim(
            sch, burst_stream(wls, policy=pol, at=1.0),
            failure_process=proc,
            config=SimConfig(heartbeat_interval=0.1,
                             checkpoint_interval=(0.05 if checkpointing
                                                  else None),
                             checkpoint_overhead=(0.002 if checkpointing
                                                  else 0.0),
                             restart_delay=0.01,
                             failure_horizon=500.0),
            rng=np.random.default_rng(seed * 2539 + 41))
        rows[pol] = _row(sim.run())
        rows[pol].update(binfo)
    return {"name": "maintenance-burst",
            "params": {"dims": dims, "rack_size": rack_size,
                       "n_flaky": n_flaky, "n_jobs": n_jobs,
                       "window": [0.5, 4.5], "belief_mode": belief_mode,
                       "seed": seed},
            "policies": rows}


@register_preset(
    "degraded-drain",
    "Nodes pass through DEGRADED (allocatable, elevated p_f) before dying, "
    "while a maintenance rack sits DRAINED: exercises the four-state "
    "lifecycle the boolean up/down model cannot express.  Fault-aware "
    "policies route around degraded nodes they are still allowed to use; "
    "fault-blind ones keep landing on them.")
def degraded_drain(policies: Sequence[str] = ("linear", "tofa"),
                   seed: int = 0, fast: bool = False,
                   device: Optional[str] = None) -> dict:
    dims = (4, 4, 4) if fast else (6, 6, 6)
    topo = TorusTopology(dims)
    net = network_for(topo)
    engine = PlacementEngine(device=device)
    rack_size = 8 if fast else 27
    racks = contiguous_racks(topo.n_nodes, rack_size)
    maintenance = racks[-1]               # administratively drained rack
    n_flaky = 10 if fast else 32
    rng0 = np.random.default_rng(seed * 521 + 23)
    pool = np.setdiff1d(np.arange(topo.n_nodes), maintenance)
    flaky = rng0.choice(pool, n_flaky, replace=False)
    n_jobs = 8 if fast else 16
    factory = mixed_size_factory(sizes=(8, 12) if fast else (16, 27))
    wls = [factory(np.random.default_rng(seed * 131 + i))
           for i in range(n_jobs)]
    # flaky nodes degrade (miss ~30% of heartbeats) and genuinely die
    # over time; the degraded band keeps them allocatable, so only
    # fault-aware policies avoid the elevated-p_f capacity
    proc = ExponentialLifetimes(flaky, mtbf=0.8 if fast else 2.5, mttr=0.5)
    truth = np.zeros(topo.n_nodes)
    truth[flaky] = 0.3
    rows = {}
    for pol in policies:
        sch = Scheduler(topo, net=net, engine=engine, seed=seed,
                        drain_threshold=0.9,       # degrade, don't drain
                        degraded_threshold=0.1)
        _converged_monitor(sch, truth, seed)
        # one heartbeat round promotes the flaky set into DEGRADED and
        # maintenance puts a whole rack administratively out of service
        sch.heartbeat_round(np.ones(topo.n_nodes, dtype=bool))
        sch.registry.mark(maintenance, NodeState.DRAINED)
        sim = ClusterSim(
            sch, burst_stream(wls, policy=pol, at=1.0),
            failure_process=proc,
            config=SimConfig(heartbeat_interval=0.1,
                             checkpoint_interval=0.05,
                             checkpoint_overhead=0.002,
                             failure_horizon=500.0),
            rng=np.random.default_rng(seed * 2311 + 37))
        res = sim.run()
        rows[pol] = _row(res)
        rows[pol]["degraded_nodes"] = int(
            (sch.registry.health_codes() == 1).sum())
    return {"name": "degraded-drain",
            "params": {"dims": dims, "n_flaky": n_flaky,
                       "rack_size": rack_size, "n_jobs": n_jobs,
                       "seed": seed},
            "policies": rows}
