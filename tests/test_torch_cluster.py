"""The port's cluster layer against the reference's, bit for bit.

``repro_torch.cluster`` (failure models and processes, node registry,
heartbeat monitor, the FANS scheduler), ``repro_torch.beliefs``,
``repro_torch.core.dragonfly`` and the legacy ``repro_torch.core.tofa``
shims are copies of the reference's host-NumPy code whose placements
come from the port's engine.  Each case draws both packages' objects from
one seed, runs the port on ``device="cpu"``, and requires equal results;
only the mapper's wall-clock fields may differ.
"""
import dataclasses
import enum
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import beliefs as R_beliefs  # noqa: E402
from repro.cluster import failures as R_failures  # noqa: E402
from repro.cluster import heartbeat as R_hb  # noqa: E402
from repro.cluster import nodes as R_nodes  # noqa: E402
from repro.cluster import scheduler as R_sched  # noqa: E402
from repro.core.dragonfly import DragonflyTopology as RefDragonfly  # noqa: E402
from repro.core.engine import PlacementEngine as RefEngine  # noqa: E402
from repro.core.engine import PlacementRequest as RefRequest  # noqa: E402
from repro.core.topology import TorusTopology as RefTorus  # noqa: E402
from repro.sim.network import TorusNetwork as RefNetwork  # noqa: E402
from repro.workloads import patterns as R_pat  # noqa: E402

from repro_torch import beliefs as T_beliefs  # noqa: E402
from repro_torch.cluster import failures as T_failures  # noqa: E402
from repro_torch.cluster import heartbeat as T_hb  # noqa: E402
from repro_torch.cluster import nodes as T_nodes  # noqa: E402
from repro_torch.cluster import scheduler as T_sched  # noqa: E402
from repro_torch.core import backend, engine as T_engine  # noqa: E402
from repro_torch.core import tofa as T_tofa  # noqa: E402
from repro_torch.core.dragonfly import DragonflyTopology  # noqa: E402
from repro_torch.core.engine import (PlacementEngine,  # noqa: E402
                                     PlacementRequest)
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.sim.network import TorusNetwork  # noqa: E402
from repro_torch.workloads import patterns as T_pat  # noqa: E402

WALL = {"place_time_s", "mean_place_time_s", "wall_time_s"}


def plain(x):
    """``x`` as nested builtins, wall-clock fields dropped, so results of
    the two packages (whose classes differ) compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name not in WALL}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [x.dtype.str, plain(x.tolist())]
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


# ------------------------------------------------------- failure layer
CAND = np.array([3, 7, 11, 19, 24, 40, 41, 63])


def _models(m):
    """Every per-instance failure model of failures module ``m``."""
    return {
        "none": m.NoFailures(),
        "bernoulli": m.BernoulliPerJob(CAND, 0.3),
        "weibull-arrival": m.WeibullArrival(CAND, mtbf=2.0, shape=0.7),
    }


def _processes(m):
    """Every time-based failure process of failures module ``m``."""
    racks = m.contiguous_racks(64, 16)
    return {
        "exponential": m.ExponentialLifetimes(CAND, mtbf=2.0, mttr=0.5),
        "exponential-permanent": m.ExponentialLifetimes(CAND, mtbf=3.0),
        "weibull": m.WeibullLifetimes(CAND, mtbf=2.0, shape=0.7, mttr=0.4),
        "correlated": m.CorrelatedOutages(racks[:2], mtbf=1.5, mttr=0.3),
        "cascading": m.CascadingOutages(racks, mtbf=2.0, mttr=0.4,
                                        spread_p=0.5, spread_delay=0.05,
                                        seed_groups=(0, 1)),
        "maintenance": m.MaintenanceWindow(racks[-1], start=0.5,
                                           duration=4.0),
        "composite": m.CompositeProcess([
            m.MaintenanceWindow(racks[-1], start=0.5, duration=4.0),
            m.ExponentialLifetimes(CAND, mtbf=0.8, mttr=0.5)]),
    }


@pytest.mark.parametrize("name", ["none", "bernoulli", "weibull-arrival"])
def test_failure_model_samples_match(name):
    model, ref = _models(T_failures)[name], _models(R_failures)[name]
    rng, rrng = np.random.default_rng(17), np.random.default_rng(17)
    for duration in np.linspace(0.05, 3.0, 40):
        got = model.sample_failed(rng, float(duration))
        assert plain(got) == plain(ref.sample_failed(rrng, float(duration)))
    if hasattr(ref, "outage_vector"):
        assert plain(model.outage_vector(64)) == plain(ref.outage_vector(64))
    assert rng.random() == rrng.random()            # same draws consumed


@pytest.mark.parametrize("name", ["exponential", "exponential-permanent",
                                  "weibull", "correlated", "cascading",
                                  "maintenance", "composite"])
def test_failure_process_traces_match(name):
    proc, ref = _processes(T_failures)[name], _processes(R_failures)[name]
    got = proc.generate(np.random.default_rng(23), 60.0)
    want = ref.generate(np.random.default_rng(23), 60.0)
    assert len(got) > 0 and plain(got) == plain(want)
    assert plain(proc.expected_p_f(64)) == plain(ref.expected_p_f(64))


def test_contiguous_racks_match():
    for n, size in ((64, 16), (216, 27), (100, 7)):
        assert plain(T_failures.contiguous_racks(n, size)) \
            == plain(R_failures.contiguous_racks(n, size))


# ------------------------------------------------- heartbeat and nodes
@pytest.mark.parametrize("estimator", ["moving-average", "ewma"])
def test_heartbeat_monitor_matches(estimator):
    make = {"moving-average": lambda m: m.MovingAverage(window=50),
            "ewma": lambda m: m.EWMA(alpha=0.05)}[estimator]
    truth = np.zeros(64)
    truth[CAND] = 0.25
    mon = T_hb.HeartbeatMonitor(64, make(T_hb))
    ref = R_hb.HeartbeatMonitor(64, make(R_hb))
    mon.simulate_rounds(np.random.default_rng(9), truth, 400)
    ref.simulate_rounds(np.random.default_rng(9), truth, 400)
    assert plain(mon.outage_probabilities()) \
        == plain(ref.outage_probabilities())
    assert plain(mon.straggler_scores()) == plain(ref.straggler_scores())
    replies = np.random.default_rng(2).random(64) > 0.3
    mon.poll(replies, dt=0.5)
    ref.poll(replies, dt=0.5)
    assert plain(mon.outage_probabilities()) \
        == plain(ref.outage_probabilities())


def test_node_registry_matches():
    reg = T_nodes.NodeRegistry(TorusTopology((4, 4, 4)))
    ref = R_nodes.NodeRegistry(RefTorus((4, 4, 4)))
    assert reg.topology_file() == ref.topology_file()
    for r, m in ((reg, T_nodes), (ref, R_nodes)):
        r.mark([1, 2], m.NodeState.DOWN)
        r.mark([5], m.NodeState.DRAINED)
        r.mark([9], m.NodeState.DEGRADED)
        r.set_outage_probabilities([9, 10], 0.2)
    assert plain(reg.health_codes()) == plain(ref.health_codes())
    assert plain(reg.allocatable_ids()) == plain(ref.allocatable_ids())
    assert plain(reg.up_ids()) == plain(ref.up_ids())
    assert plain(reg.true_outage_vector()) == plain(ref.true_outage_vector())
    back = T_nodes.NodeRegistry.from_topology_file(reg.topology_file(),
                                                   (4, 4, 4))
    assert back.topology_file() == reg.topology_file()


# ------------------------------------------------------------ scheduler
def _schedulers(**kw):
    topo, rtopo = TorusTopology((4, 4, 4)), RefTorus((4, 4, 4))
    sch = T_sched.Scheduler(topo, net=TorusNetwork(topo),
                            engine=PlacementEngine(device="cpu"), **kw)
    ref = R_sched.Scheduler(rtopo, net=RefNetwork(rtopo),
                            engine=RefEngine(), **kw)
    return sch, ref


def _record(rec):
    """A job record as builtins.  Hop-bytes are the engine's float64 sum,
    held to the engine's contract (rtol 1e-9 of the reference; the sum's
    order differs on the torch backend); everything else is exact."""
    plan = rec.placement
    return (rec.state, rec.restarts, rec.requeues, rec.runtime,
            None if plan is None else (plain(plan.placement), plan.policy,
                                       pytest.approx(plan.hop_bytes,
                                                     rel=1e-9),
                                       plan.provenance,
                                       plan.faulty_nodes_used))


def test_scheduler_elastic_replacement_matches():
    """A node under a running job dies: ``engine.replace`` moves only the
    displaced processes, identically to the reference's."""
    sch, ref = _schedulers()
    sch.heartbeat_round(np.ones(64, dtype=bool))
    ref.heartbeat_round(np.ones(64, dtype=bool))
    rec = sch.submit(T_sched.Job(T_pat.lammps_like(27), distribution="tofa"))
    rrec = ref.submit(R_sched.Job(R_pat.lammps_like(27),
                                  distribution="tofa"))
    assert _record(rec) == _record(rrec)
    victim = int(rec.placement.placement[10])
    before = rec.placement.placement.copy()
    got = sch.handle_node_failure([victim])
    want = ref.handle_node_failure([victim])
    assert [r.job.workload.name for r in got] \
        == [r.job.workload.name for r in want] and len(got) == 1
    assert _record(rec) == _record(rrec)
    new = rec.placement.placement
    assert rec.placement.provenance == "replace-incremental"
    assert victim not in set(new.tolist()) and rec.restarts == 1
    assert int((new != before).sum()) == 1          # only the victim moved
    assert plain(sch.cluster_state().health) \
        == plain(ref.cluster_state().health)


def test_scheduler_queue_and_backfill_match():
    """A burst of jobs wider than the cluster queues, backfills and
    drains identically; a failure that cannot be absorbed requeues."""
    sch, ref = _schedulers(drain_threshold=0.6, degraded_threshold=0.1)
    truth = np.zeros(64)
    truth[CAND] = 0.3
    for s in (sch, ref):
        s.monitor.simulate_rounds(np.random.default_rng(4), truth, 200)
        s.heartbeat_round(np.ones(64, dtype=bool))
    sizes = (27, 24, 12, 8, 27, 8)
    recs = [sch.submit(T_sched.Job(T_pat.npb_dt_like(n), distribution=p))
            for n, p in zip(sizes, ("tofa", "linear", "greedy", "topo",
                                    "tofa", "random"))]
    rrecs = [ref.submit(R_sched.Job(R_pat.npb_dt_like(n), distribution=p))
             for n, p in zip(sizes, ("tofa", "linear", "greedy", "topo",
                                     "tofa", "random"))]
    assert [_record(r) for r in recs] == [_record(r) for r in rrecs]
    assert any(r.state == "pending" for r in recs)
    running = [r for r in recs if r.state == "running"]
    dead = [int(x) for x in running[0].placement.placement[:3]]
    sch.handle_node_failure(dead)
    ref.handle_node_failure(dead)
    assert [_record(r) for r in recs] == [_record(r) for r in rrecs]
    sch.complete(running[1].job.job_id)
    ref.complete(rrecs[recs.index(running[1])].job.job_id)
    sch.recover(dead)
    ref.recover(dead)
    assert [_record(r) for r in recs] == [_record(r) for r in rrecs]
    assert plain(sch.stats()) == plain(ref.stats())
    assert plain(sch.estimated_outage()) == plain(ref.estimated_outage())


def test_scheduler_targets_the_card(monkeypatch):
    """Without an engine or ``device`` the scheduler builds its engine on
    ``cuda``: with no GPU it raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    with pytest.raises(backend.BackendUnavailableError):
        T_sched.Scheduler(TorusTopology((4, 4, 4)))
    sch = T_sched.Scheduler(TorusTopology((4, 4, 4)), device="cpu")
    assert sch.engine.backend.device.type == "cpu"


# ------------------------------------------------------ legacy shims
@pytest.mark.parametrize("policy", ["linear", "tofa"])
def test_plan_to_result_matches(policy):
    p_f = np.zeros(64)
    p_f[CAND] = 0.02
    plan = PlacementEngine(device="cpu").place(
        PlacementRequest(comm=T_pat.npb_dt_like(24).comm,
                         topology=TorusTopology((4, 4, 4)), p_f=p_f),
        policy=policy, rng=np.random.default_rng(1))
    ref = RefEngine().place(
        RefRequest(comm=R_pat.npb_dt_like(24).comm,
                   topology=RefTorus((4, 4, 4)), p_f=p_f),
        policy=policy, rng=np.random.default_rng(1))
    res, rres = plan.to_result(), ref.to_result()
    assert isinstance(res, T_tofa.PlacementResult)
    assert plain(res) == plain(rres)
    assert res.as_pairs() == rres.as_pairs()


def test_legacy_shims_use_the_default_engine(monkeypatch):
    """``tofa_place`` / ``place`` run the shared default engine, which is
    on ``cuda``: without a GPU they raise.  Given a CPU default engine
    they return the reference's placement."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    monkeypatch.setattr(T_engine, "_DEFAULT_ENGINES", {})
    comm = T_pat.npb_dt_like(12).comm
    topo = TorusTopology((4, 4, 4))
    with pytest.raises(backend.BackendUnavailableError):
        T_engine.default_engine()
    with pytest.raises(backend.BackendUnavailableError):
        with pytest.deprecated_call():
            T_tofa.tofa_place(comm, topo)
    cpu = T_engine.default_engine("cpu")
    assert T_engine.default_engine("cpu") is cpu
    monkeypatch.setattr(T_tofa, "default_engine", lambda: cpu)
    with pytest.deprecated_call():
        got = T_tofa.place("greedy", comm, topo,
                           rng=np.random.default_rng(2))
    ref = RefEngine().place(
        RefRequest(comm=R_pat.npb_dt_like(12).comm,
                   topology=RefTorus((4, 4, 4))),
        policy="greedy", rng=np.random.default_rng(2)).to_result()
    assert plain(got) == plain(ref)
    assert set(T_tofa.POLICIES) >= {"linear", "greedy", "topo", "tofa"}


# ------------------------------------------------------------ dragonfly
@pytest.mark.parametrize("shape", [(2, 4, 2, None), (4, 8, 4, 9)])
def test_dragonfly_matches(shape):
    p, a, h, g = shape
    kw = {} if g is None else {"g": g}
    topo, ref = DragonflyTopology(p=p, a=a, h=h, **kw), \
        RefDragonfly(p=p, a=a, h=h, **kw)
    n = topo.n_nodes
    assert n == ref.n_nodes
    assert plain(topo.hop_matrix()) == plain(ref.hop_matrix())
    assert plain(topo.coords_array()) == plain(ref.coords_array())
    assert plain(topo.hierarchy_groups(8)) == plain(ref.hierarchy_groups(8))
    p_f = np.zeros(n)
    p_f[np.random.default_rng(3).choice(n, 6, replace=False)] = 0.3
    W = topo.weight_matrix(p_f)
    assert plain(W) == plain(ref.weight_matrix(p_f))
    p2 = p_f.copy()
    p2[np.flatnonzero(p_f)[:2]] = 0.0
    p2[np.random.default_rng(4).choice(n, 2, replace=False)] = 0.5
    assert plain(topo.weight_matrix_update(W, p_f, p2)) \
        == plain(ref.weight_matrix_update(ref.weight_matrix(p_f), p_f, p2))


# -------------------------------------------------------------- beliefs
def _belief_models(m, truth, racks):
    return {
        "exponential-bayes": m.ExponentialBayes(),
        "weibull-mom": m.WeibullMoM(),
        "rack-pooled": m.RackPooledBayes(racks),
        "oracle": m.OracleBeliefs(truth),
        "static": m.StaticPrior(0.1),
        "adversarial": m.AdversarialBeliefs(truth),
    }


@pytest.mark.parametrize("model", ["exponential-bayes", "weibull-mom",
                                   "rack-pooled", "oracle", "static",
                                   "adversarial"])
def test_belief_tracker_matches(model):
    """A tracker trained on one failure trace and then fed live events
    emits the reference's belief, and the calibration metrics score it
    identically."""
    racks = T_failures.contiguous_racks(64, 16)
    proc = T_failures.CompositeProcess([
        T_failures.CorrelatedOutages(racks[:1], mtbf=1.0, mttr=0.3),
        T_failures.ExponentialLifetimes(CAND, mtbf=4.0, mttr=0.5)])
    rproc = R_failures.CompositeProcess([
        R_failures.CorrelatedOutages(racks[:1], mtbf=1.0, mttr=0.3),
        R_failures.ExponentialLifetimes(CAND, mtbf=4.0, mttr=0.5)])
    truth = proc.expected_p_f(64)
    tr = T_beliefs.BeliefTracker(
        64, _belief_models(T_beliefs, truth, racks)[model])
    rtr = R_beliefs.BeliefTracker(
        64, _belief_models(R_beliefs, truth, racks)[model])
    events = proc.generate(np.random.default_rng(5), 60.0)
    tr.ingest_events(events, t_end=60.0)
    rtr.ingest_events(rproc.generate(np.random.default_rng(5), 60.0),
                      t_end=60.0)
    tr.rebase(0.0)
    rtr.rebase(0.0)
    for t, kind, nodes in ((0.5, "fail", [3, 7]), (0.9, "repair", [3]),
                           (1.4, "fail", [40])):
        for x in (tr, rtr):
            (x.observe_failure if kind == "fail" else x.observe_repair)(
                nodes, t)
            x.observe_heartbeat(t)
    p, rp = tr.p_f_vector(now=2.0), rtr.p_f_vector(now=2.0)
    assert plain(p) == plain(rp)
    assert plain(tr.stats(now=2.0)) == plain(rtr.stats(now=2.0))
    out = T_beliefs.window_outcomes(events, 64, 60.0, 1.0)
    assert plain(out) == plain(R_beliefs.window_outcomes(
        rproc.generate(np.random.default_rng(5), 60.0), 64, 60.0, 1.0))
    pw = np.broadcast_to(p, out.shape)
    for fn in ("brier_score", "log_loss", "expected_calibration_error"):
        assert plain(getattr(T_beliefs, fn)(pw, out)) \
            == plain(getattr(R_beliefs, fn)(pw, out))
    assert plain(T_beliefs.reliability_diagram(pw, out)) \
        == plain(R_beliefs.reliability_diagram(pw, out))
    for fn in ("belief_mse", "belief_mae", "pattern_confusion"):
        assert plain(getattr(T_beliefs, fn)(p, truth)) \
            == plain(getattr(R_beliefs, fn)(rp, truth))
