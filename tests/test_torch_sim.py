"""The port's simulation layer against the reference's, bit for bit.

``repro_torch.sim`` (network models, single-job physics, the event
queue, the paper's batch protocol, the event-driven cluster simulator)
and ``repro_torch.workloads.arrivals`` are copies of the reference's
host-NumPy code whose placements come from the port's engine.  Every
case builds both packages' objects from the same seeds, runs the port on
``device="cpu"``, and requires every result field to equal the
reference's exactly; only the mapper's wall-clock fields may differ.
"""
import dataclasses
import enum
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster import failures as R_failures  # noqa: E402
from repro.core.engine import PlacementEngine as RefEngine  # noqa: E402
from repro.core.fattree import FatTreeTopology as RefFatTree  # noqa: E402
from repro.core.dragonfly import DragonflyTopology as RefDragonfly  # noqa: E402
from repro.core.topology import TorusTopology as RefTorus  # noqa: E402
from repro.sim import batchsim as R_batch  # noqa: E402
from repro.sim import events as R_events  # noqa: E402
from repro.sim import jobsim as R_jobsim  # noqa: E402
from repro.sim import network as R_net  # noqa: E402
from repro.workloads import arrivals as R_arr  # noqa: E402
from repro.workloads import patterns as R_pat  # noqa: E402

from repro_torch.cluster import failures as T_failures  # noqa: E402
from repro_torch.cluster.scheduler import Scheduler  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.core.dragonfly import DragonflyTopology  # noqa: E402
from repro_torch.core.engine import (PlacementEngine,  # noqa: E402
                                     PlacementRequest)
from repro_torch.core.fattree import FatTreeTopology  # noqa: E402
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.sim import batchsim as T_batch  # noqa: E402
from repro_torch.sim import events as T_events  # noqa: E402
from repro_torch.sim import jobsim as T_jobsim  # noqa: E402
from repro_torch.sim import network as T_net  # noqa: E402
from repro_torch.sim.clustersim import ClusterSim, SimConfig  # noqa: E402
from repro_torch.workloads import arrivals as T_arr  # noqa: E402
from repro_torch.workloads import patterns as T_pat  # noqa: E402

# the mapper's wall clock: the only result fields allowed to differ
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


def hosts():
    """(port topology, reference topology) pairs: torus, fat tree and
    dragonfly."""
    return {
        "torus": (TorusTopology((4, 4, 4)), RefTorus((4, 4, 4))),
        "fattree": (FatTreeTopology(4), RefFatTree(4)),
        "dragonfly": (DragonflyTopology(p=2, a=4, h=2),
                      RefDragonfly(p=2, a=4, h=2)),
    }


def _placements(n_nodes: int, n: int, count: int = 6):
    rng = np.random.default_rng(31)
    return [rng.choice(n_nodes, n, replace=False) for _ in range(count)]


# ------------------------------------------------------------- network
@pytest.mark.parametrize("host", ["torus", "fattree", "dragonfly"])
def test_network_models_match(host):
    topo, rtopo = hosts()[host]
    net, rnet = T_net.network_for(topo), R_net.network_for(rtopo)
    assert type(net).__name__ == type(rnet).__name__
    n = 12
    wl, rwl = T_pat.npb_dt_like(n), R_pat.npb_dt_like(n)
    fail_rng = np.random.default_rng(3)
    for p in _placements(topo.n_nodes, n):
        assert net.comm_time(wl.comm, p) == rnet.comm_time(rwl.comm, p)
        if host == "torus":
            assert net.link_loads(wl.comm, p) == rnet.link_loads(rwl.comm, p)
        for k in (0, 1, 3):
            failed = fail_rng.choice(topo.n_nodes, k, replace=False)
            assert (net.touches_failed(wl.comm, p, failed)
                    == rnet.touches_failed(rwl.comm, p, failed))


@pytest.mark.parametrize("wl_name", ["npb_dt", "lammps", "halo3d"])
def test_jobsim_matches(wl_name):
    topo, rtopo = TorusTopology((4, 4, 4)), RefTorus((4, 4, 4))
    net, rnet = T_net.TorusNetwork(topo), R_net.TorusNetwork(rtopo)
    make = {"npb_dt": lambda m: m.npb_dt_like(24),
            "lammps": lambda m: m.lammps_like(27),
            "halo3d": lambda m: m.halo3d((3, 3, 3))}[wl_name]
    wl, rwl = make(T_pat), make(R_pat)
    fail_rng = np.random.default_rng(4)
    for p in _placements(64, wl.n_ranks, 4):
        t = T_jobsim.successful_runtime(wl, p, net)
        assert t == R_jobsim.successful_runtime(rwl, p, rnet)
        failed = fail_rng.choice(64, 2, replace=False)
        out = T_jobsim.simulate_instance(wl, p, net, failed, runtime=t)
        ref = R_jobsim.simulate_instance(rwl, p, rnet, failed, runtime=t)
        assert plain(out) == plain(ref)


def test_event_queue_order_matches():
    q, rq = T_events.EventQueue(), R_events.EventQueue()
    rng = np.random.default_rng(8)
    types = list(T_events.EventType)
    for i in range(60):
        t = float(rng.integers(0, 10))        # ties on time and type
        k = int(rng.integers(len(types)))
        q.push(t, types[k], job=i)
        rq.push(t, list(R_events.EventType)[k], job=i)
    got = [(e.time, int(e.type), e["job"]) for e in q.drain()]
    ref = [(e.time, int(e.type), e["job"]) for e in rq.drain()]
    assert got == ref and len(got) == 60


def test_arrival_streams_match():
    wls = [T_pat.npb_dt_like(8), T_pat.halo3d((2, 2, 2))]
    rwls = [R_pat.npb_dt_like(8), R_pat.halo3d((2, 2, 2))]

    def specs(s):
        return [(plain(j.workload.comm.G_v), j.workload.name, j.policy,
                 j.submit_time, j.after_previous,
                 plain(j.fixed_placement)) for j in s]

    fixed = np.arange(8)
    assert specs(T_arr.serial_stream(wls, policy="topo",
                                     fixed_placement=fixed)) \
        == specs(R_arr.serial_stream(rwls, policy="topo",
                                     fixed_placement=fixed))
    assert specs(T_arr.burst_stream(wls, policy="linear", at=2.0)) \
        == specs(R_arr.burst_stream(rwls, policy="linear", at=2.0))
    fac = T_arr.mixed_size_factory(sizes=(8, 12, 18))
    rfac = R_arr.mixed_size_factory(sizes=(8, 12, 18))
    assert specs(T_arr.poisson_stream(fac, rate=4.0, n_jobs=12,
                                      rng=np.random.default_rng(5))) \
        == specs(R_arr.poisson_stream(rfac, rate=4.0, n_jobs=12,
                                      rng=np.random.default_rng(5)))
    for i in range(6):
        a = fac(np.random.default_rng(i))
        b = rfac(np.random.default_rng(i))
        assert (a.name, a.rounds, a.flops_per_rank) \
            == (b.name, b.rounds, b.flops_per_rank)
        assert np.array_equal(a.comm.G_v, b.comm.G_v)
        assert np.array_equal(a.comm.G_m, b.comm.G_m)


# ------------------------------------------------------ the batch protocol
@pytest.fixture(scope="module")
def engines():
    """One port engine on the CPU and one reference NumPy engine, shared
    across the batch cases as ``run_scenario`` shares them."""
    return PlacementEngine(device="cpu"), RefEngine()


@pytest.mark.parametrize("policy", ["linear", "topo", "greedy", "tofa"])
@pytest.mark.parametrize("mode", ["paper", "checkpoint", "blind"])
def test_run_batch_matches(engines, policy, mode):
    """``run_batch`` equals the reference's: the placement, every
    completion time and abort count; ``blind`` places with
    ``known_p_f=None``."""
    engine, rengine = engines
    topo, rtopo = TorusTopology((4, 4, 4)), RefTorus((4, 4, 4))
    net, rnet = T_net.TorusNetwork(topo), R_net.TorusNetwork(rtopo)
    cand = np.random.default_rng(5).choice(64, 8, replace=False)
    fm = T_failures.BernoulliPerJob(cand, 0.05)
    rfm = R_failures.BernoulliPerJob(cand, 0.05)
    known = None if mode == "blind" else fm.outage_vector(64)
    kw = ({"checkpoint_interval": 0.01, "checkpoint_overhead": 0.001}
          if mode == "checkpoint" else {})
    got = T_batch.run_batch(T_pat.npb_dt_like(24), policy, net, fm, known,
                            n_instances=40, rng=np.random.default_rng(11),
                            engine=engine, **kw)
    ref = R_batch.run_batch(R_pat.npb_dt_like(24), policy, rnet, rfm, known,
                            n_instances=40, rng=np.random.default_rng(11),
                            engine=rengine, **kw)
    assert got.placement.dtype == np.int64
    assert plain(got) == plain(ref)
    if policy == "linear":               # the abort path was taken
        assert got.n_aborted_attempts > 0


@pytest.mark.parametrize("host", ["torus", "fattree"])
def test_run_scenario_matches(host):
    topo, rtopo = {"torus": (None, None),
                   "fattree": (FatTreeTopology(4), RefFatTree(4))}[host]
    kw = dict(policies=("linear", "topo", "tofa"), dims=(4, 4, 4),
              n_batches=2, n_instances=20, n_faulty=6, p_f=0.05, seed=3)
    got = T_batch.run_scenario(lambda: T_pat.npb_dt_like(12), device="cpu",
                               topology=topo, **kw)
    ref = R_batch.run_scenario(lambda: R_pat.npb_dt_like(12),
                               topology=rtopo, **kw)
    assert plain(got) == plain(ref)
    assert set(got) == {"linear", "topo", "tofa"}


# --------------------------------------- event simulator vs run_batch
def _event_sim_batch(topo, net, wl, pol, fm, known, n_instances, seed,
                     engine, **cfg):
    """Mirror run_batch through the port's event loop: same engine, same
    RNG stream."""
    rng = np.random.default_rng(seed)
    plan = engine.place(
        PlacementRequest(comm=wl.comm, topology=topo, p_f=known),
        policy=pol, rng=rng)
    sim = ClusterSim(
        Scheduler(topo, net=net, engine=engine),
        T_arr.serial_stream([wl] * n_instances, policy=pol,
                            fixed_placement=plan.placement),
        attempt_failures=fm, rng=rng, config=SimConfig(**cfg))
    return sim.run()


def test_event_sim_matches_run_batch_exactly(engines):
    """Serial arrivals and per-batch Bernoulli N_f: the port's event
    simulator reproduces the port's run_batch bit for bit."""
    engine, _ = engines
    topo = TorusTopology((4, 4, 4))
    net = T_net.TorusNetwork(topo)
    wl = T_pat.npb_dt_like(24)
    cand = np.random.default_rng(5).choice(64, 8, replace=False)
    fm = T_failures.BernoulliPerJob(cand, 0.05)
    known = fm.outage_vector(64)
    for pol in ("linear", "tofa"):
        rb = T_batch.run_batch(wl, pol, net, fm, known, n_instances=40,
                               rng=np.random.default_rng(11), engine=engine)
        res = _event_sim_batch(topo, net, wl, pol, fm, known, 40, 11,
                               engine)
        assert res.makespan == rb.completion_time
        assert res.aborted_attempts == rb.n_aborted_attempts
        assert not res.truncated


def test_event_sim_matches_run_batch_with_checkpointing(engines):
    """With checkpoints the draws and charge terms are the same; only the
    summation order differs (absolute event times against one
    accumulator), so the makespan agrees to the reference test's 1e-9."""
    engine, _ = engines
    topo = TorusTopology((4, 4, 4))
    net = T_net.TorusNetwork(topo)
    wl = T_pat.npb_dt_like(24)
    fm = T_failures.BernoulliPerJob(np.arange(16), 0.3)
    rb = T_batch.run_batch(wl, "linear", net, fm, None, n_instances=30,
                           rng=np.random.default_rng(2), engine=engine,
                           checkpoint_interval=0.02,
                           checkpoint_overhead=0.001)
    res = _event_sim_batch(topo, net, wl, "linear", fm, None, 30, 2,
                           engine, checkpoint_interval=0.02,
                           checkpoint_overhead=0.001)
    assert res.makespan == pytest.approx(rb.completion_time, rel=1e-9)
    assert res.aborted_attempts == rb.n_aborted_attempts > 0


# --------------------------------------------------------- the device
@pytest.mark.parametrize("entry", ["run_batch", "run_scenario"])
def test_batch_entry_points_target_the_card(monkeypatch, entry):
    """Without an engine or ``device`` the batch protocol builds its engine
    on ``cuda``: with no GPU it raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    topo = TorusTopology((4, 4, 4))
    fm = T_failures.BernoulliPerJob(np.array([1, 2]), 0.05)
    calls = {
        "run_batch": lambda: T_batch.run_batch(
            T_pat.npb_dt_like(8), "tofa", T_net.TorusNetwork(topo), fm,
            fm.outage_vector(64), n_instances=2),
        "run_scenario": lambda: T_batch.run_scenario(
            lambda: T_pat.npb_dt_like(8), ("tofa",), dims=(4, 4, 4),
            n_batches=1, n_instances=2),
    }
    with pytest.raises(backend.BackendUnavailableError):
        calls[entry]()
