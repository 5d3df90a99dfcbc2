"""The port's online placement service against the reference's.

The first part mirrors ``tests/test_service.py`` on ``repro_torch`` with
every engine on ``device="cpu"`` (the plain PyTorch kernels).  The second
holds the port to the reference in the same process: the request storm of
``benchmarks/serve_storm.py`` (fast size) run through both services gives
every simulated field of each policy's row and the placement log bit for
bit; ``kv_shard_bytes`` equals the reference's for every architecture;
and ``chip_smoke.py``'s ``EXPECTED_STORM`` is what the reference's full
storm returns.  Without ``device`` the service targets the card and
raises when there is none.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.core.topology import TorusTopology as RefTorus  # noqa: E402
from repro.service import PlacementService as RefService  # noqa: E402
from repro.service import kv_shard_bytes as ref_kv_shard_bytes  # noqa: E402

from repro_torch.cluster.scheduler import Job, Scheduler  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.core.state import NodeHealth  # noqa: E402
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.service import (AdmissionQueue, LatencyHistogram,  # noqa
                                 PlacementService, ReplicaSpec, SLOClass,
                                 elastic_request, kv_shard_bytes,
                                 replica_request)
from repro_torch.service.requests import _analytic_cache_bytes  # noqa: E402
from repro_torch.workloads.arrivals import (burst_stream,  # noqa: E402
                                            mixed_size_factory,
                                            poisson_stream, serial_stream)
from repro_torch.workloads.patterns import halo3d, npb_dt_like  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def ref_storm():
    """The reference's storm benchmark module (``build_stream`` and
    ``build_churn``)."""
    return _load("serve_storm", ROOT / "benchmarks" / "serve_storm.py")


def small_service(seed=0, dims=(3, 3, 3), **kw):
    return PlacementService(TorusTopology(dims), seed=seed,
                            drain_interval=0.25, restart_delay=0.5,
                            device="cpu", **kw)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

class TestRequests:
    def test_replica_workload_layout(self):
        spec = ReplicaSpec(shards_per_replica=3, shard_bytes=1e8)
        wl = spec.workload(2)
        assert spec.ranks_per_replica == 4
        assert wl.n_ranks == 8
        G = wl.comm.G_v
        assert G[0, 1] > 0 and G[4, 5] > 0
        assert 0 < G[0, 4] < G[0, 1]
        assert G[1, 5] == 0

    def test_kv_shard_bytes_scaling(self):
        cfg = get_arch("smollm-135m")
        one = kv_shard_bytes(cfg, batch=8, max_seq=4096, shards=1)
        four = kv_shard_bytes(cfg, batch=8, max_seq=4096, shards=4)
        assert one > 0 and one / four == pytest.approx(4.0)
        assert one == pytest.approx(
            2 * cfg.n_layers * 8 * cfg.n_kv_heads * 4096
            * cfg.head_dim_ * 2, rel=0.01)

    def test_request_validation(self):
        wl = npb_dt_like(8)
        with pytest.raises(ValueError, match="deadline"):
            elastic_request(wl, submit_time=5.0, deadline=1.0)
        with pytest.raises(ValueError, match="hold_time"):
            elastic_request(wl, hold_time=0.0)
        with pytest.raises(ValueError, match="shards"):
            kv_shard_bytes(None, 1, 1, shards=0)

    def test_req_ids_unique(self):
        a = elastic_request(npb_dt_like(8))
        b = elastic_request(npb_dt_like(8))
        assert a.req_id != b.req_id


# ---------------------------------------------------------------------------
# admission queue
# ---------------------------------------------------------------------------

class TestAdmissionQueue:
    def test_slo_lane_ordering(self):
        q = AdmissionQueue()
        wl = npb_dt_like(8)
        be = elastic_request(wl, slo=SLOClass.BEST_EFFORT)
        st = elastic_request(wl, slo=SLOClass.STANDARD)
        ia = elastic_request(wl, slo=SLOClass.INTERACTIVE)
        for r in (be, st, ia):
            assert q.push(r, now=0.0)
        batch = q.drain(now=0.0, capacity=100)
        assert [r.req_id for r in batch] == [ia.req_id, st.req_id,
                                             be.req_id]

    def test_edf_within_lane(self):
        q = AdmissionQueue()
        wl = npb_dt_like(8)
        late = elastic_request(wl, slo=SLOClass.STANDARD, deadline=50.0)
        soon = elastic_request(wl, slo=SLOClass.STANDARD, deadline=10.0)
        q.push(late, 0.0)
        q.push(soon, 0.0)
        assert q.head(SLOClass.STANDARD).req_id == soon.req_id
        assert [r.req_id for r in q.drain(0.0, 100)] == [soon.req_id,
                                                         late.req_id]

    def test_deadline_shedding(self):
        q = AdmissionQueue()
        wl = npb_dt_like(8)
        r1 = elastic_request(wl, deadline=5.0)
        r2 = elastic_request(wl, deadline=50.0)
        q.push(r1, 0.0)
        q.push(r2, 0.0)
        shed = q.shed_expired(now=10.0)
        assert [r.req_id for r in shed] == [r1.req_id]
        assert q.depth == 1
        assert not q.push(elastic_request(wl, deadline=15.0), now=15.0)

    def test_bounded_depth_rejects(self):
        q = AdmissionQueue(max_depth=1)
        wl = npb_dt_like(8)
        assert q.push(elastic_request(wl), 0.0)
        assert not q.push(elastic_request(wl), 0.0)
        assert q.peak_depth == 1
        with pytest.raises(ValueError):
            AdmissionQueue(max_depth=0)

    def test_capacity_backfill(self):
        q = AdmissionQueue()
        wide = elastic_request(npb_dt_like(16), slo=SLOClass.STANDARD)
        narrow = elastic_request(npb_dt_like(4), slo=SLOClass.BEST_EFFORT)
        q.push(wide, 0.0)
        q.push(narrow, 0.0)
        batch = q.drain(0.0, capacity=8)
        assert [r.req_id for r in batch] == [narrow.req_id]
        assert q.depth == 1
        assert q.head(SLOClass.STANDARD).req_id == wide.req_id

    def test_remove(self):
        q = AdmissionQueue()
        r = elastic_request(npb_dt_like(8))
        q.push(r, 0.0)
        assert q.remove(r.req_id) is r
        assert q.remove(r.req_id) is None
        assert q.depth == 0


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_histogram_percentiles(self):
        h = LatencyHistogram()
        vals = np.linspace(0.01, 1.0, 100)
        for v in vals:
            h.observe(float(v))
        assert h.p50 == pytest.approx(float(np.percentile(vals, 50)))
        assert h.p99 <= h.max == pytest.approx(1.0)
        assert len(h) == 100
        with pytest.raises(ValueError):
            h.observe(-1.0)

    def test_empty_histogram(self):
        h = LatencyHistogram()
        assert h.p50 == -1.0 and h.p99 == -1.0 and h.mean == -1.0
        assert h.to_dict()["n"] == 0


# ---------------------------------------------------------------------------
# service behavior
# ---------------------------------------------------------------------------

class TestService:
    def test_place_and_complete(self):
        svc = small_service()
        req = elastic_request(npb_dt_like(8), hold_time=2.0)
        res = svc.run([req])
        reply = res.replies[req.req_id]
        assert reply.status == "completed"
        assert reply.admission_latency == pytest.approx(0.25)
        assert len(reply.nodes) == 8
        assert res.metrics.placed == 1 and res.metrics.completed == 1

    def test_service_deadline_shed(self):
        svc = small_service()
        req = elastic_request(npb_dt_like(8), deadline=0.1, hold_time=1.0)
        res = svc.run([req])
        assert res.replies[req.req_id].status == "shed"
        assert res.metrics.shed == 1 and res.metrics.placed == 0

    def test_preemption_under_pressure(self):
        svc = small_service()   # 27 nodes
        fillers = [elastic_request(halo3d((2, 2, 2)),
                                   slo=SLOClass.BEST_EFFORT,
                                   submit_time=0.0, hold_time=100.0)
                   for _ in range(3)]           # 24 of 27 nodes held
        urgent = replica_request(shard_bytes=1e8, n_replicas=2,
                                 shards_per_replica=3,
                                 slo=SLOClass.INTERACTIVE,
                                 submit_time=1.0, hold_time=1.0)
        res = svc.run(fillers + [urgent], horizon=10.0)
        assert res.replies[urgent.req_id].status == "completed"
        assert res.metrics.preempted >= 1
        preempted = [r for r in res.replies.values() if r.preemptions]
        assert preempted and all(r.slo == SLOClass.BEST_EFFORT
                                 for r in preempted)
        assert res.metrics.requeued >= 1

    def test_standard_does_not_preempt(self):
        svc = small_service()
        fillers = [elastic_request(halo3d((2, 2, 2)),
                                   slo=SLOClass.BEST_EFFORT,
                                   submit_time=0.0, hold_time=5.0)
                   for _ in range(3)]
        std = elastic_request(npb_dt_like(8), slo=SLOClass.STANDARD,
                              submit_time=1.0, hold_time=1.0)
        res = svc.run(fillers + [std])
        assert res.metrics.preempted == 0
        assert res.replies[std.req_id].status == "completed"
        assert res.replies[std.req_id].admission_latency > 1.0

    def test_resize_grow_and_shrink(self):
        svc = small_service(dims=(4, 4, 4))
        req = replica_request(shard_bytes=1e8, n_replicas=2,
                              shards_per_replica=3, hold_time=50.0)
        svc.submit(req, now=0.0)
        svc.tick(0.25)
        lease = svc.leases[req.req_id]
        orig = lease.nodes.copy()
        assert len(orig) == 8
        grown = svc.resize(req.req_id, 3, now=1.0)
        assert len(grown.nodes) == 12
        assert np.array_equal(grown.nodes[:8], orig)
        assert not np.isin(grown.nodes[8:], orig).any()
        assert grown.workload.n_ranks == 12
        shrunk = svc.resize(req.req_id, 1, now=2.0)
        assert np.array_equal(shrunk.nodes, orig[:4])
        assert svc.metrics.resized == 2
        assert svc.free_capacity() == 64 - 4
        with pytest.raises(ValueError):
            svc.resize(req.req_id, 0, now=3.0)
        with pytest.raises(KeyError):
            svc.resize(999999, 2, now=3.0)

    def test_failure_replacement_parity_with_engine(self):
        req = elastic_request(npb_dt_like(8), hold_time=100.0)

        def setup():
            svc = small_service(seed=3, dims=(4, 4, 4))
            svc.submit(req, now=0.0)
            svc.tick(0.25)
            return svc
        a_svc = setup()
        b_svc = setup()
        assert np.array_equal(a_svc.leases[req.req_id].nodes,
                              b_svc.leases[req.req_id].nodes)
        victim = [int(a_svc.leases[req.req_id].nodes[0])]
        touched = a_svc.handle_failure(victim, now=1.0)
        assert touched == [req.req_id]
        b_svc.state = b_svc.state.with_health(victim, NodeHealth.DOWN)
        lease = b_svc.leases[req.req_id]
        plan = b_svc.engine.replace(
            lease.plan, victim,
            state=b_svc.busy_view(exclude=req.req_id), rng=b_svc.rng)
        assert plan.provenance == "replace-incremental"
        assert np.array_equal(a_svc.leases[req.req_id].nodes,
                              plan.placement)
        assert a_svc.metrics.replaced == 1
        assert a_svc.replies[req.req_id].replacements == 1

    def test_failure_requeues_when_no_capacity(self):
        svc = small_service()   # 27 nodes
        req = elastic_request(halo3d((3, 3, 3)), hold_time=100.0)
        svc.submit(req, now=0.0)
        svc.tick(0.25)
        svc.handle_failure([0], now=1.0)
        assert req.req_id not in svc.leases
        assert svc.replies[req.req_id].status == "queued"
        assert svc.metrics.requeued == 1

    def test_failure_untouched_lease_fast_path(self):
        svc = small_service(dims=(4, 4, 4))
        req = elastic_request(npb_dt_like(8), hold_time=100.0)
        svc.submit(req, now=0.0)
        svc.tick(0.25)
        used = set(int(x) for x in svc.leases[req.req_id].nodes)
        spare = next(i for i in range(64) if i not in used)
        touched = svc.handle_failure([spare], now=1.0)
        assert touched == []
        assert svc.metrics.replace_skipped == 1
        assert svc.metrics.replaced == 0

    def test_recovery_restores_capacity(self):
        svc = small_service()
        svc.handle_failure([0, 1], now=0.0)
        assert svc.free_capacity() == 25
        svc.handle_recover([0, 1], now=1.0)
        assert svc.free_capacity() == 27

    def test_determinism_same_seed_same_log(self):
        rng = np.random.default_rng(11)
        reqs, t = [], 0.0
        for i in range(30):
            t += float(rng.exponential(0.2))
            reqs.append(elastic_request(npb_dt_like(8),
                                        slo=SLOClass(i % 3),
                                        submit_time=t, hold_time=1.0))
        belief = np.where(np.arange(64) % 7 == 0, 0.2, 0.0)

        def storm():
            svc = small_service(seed=5, dims=(4, 4, 4))
            res = svc.run(reqs, failures=[(2.0, [5]), (4.0, [9])],
                          heartbeat_interval=0.5, belief=belief,
                          belief_jitter=0.2)
            assert res.metrics.completed == 30
            return res.placement_log
        assert storm() == storm()

    def test_busy_view_keeps_route_key_warm(self):
        svc = small_service(dims=(4, 4, 4))
        base_key = svc.state.key
        for _ in range(3):
            svc.submit(elastic_request(npb_dt_like(8), hold_time=50.0),
                       now=0.0)
        svc.tick(0.25)
        view = svc.busy_view()
        assert view.is_overlay and view.route_key == base_key
        svc.heartbeat(np.zeros(64), now=0.5)
        assert svc.state.key == base_key

    def test_storm_cache_hit_rate(self):
        svc = small_service(seed=0, dims=(4, 4, 4))
        rng = np.random.default_rng(1)
        reqs, t = [], 0.0
        for _ in range(120):
            t += float(rng.exponential(0.2))
            reqs.append(elastic_request(npb_dt_like(8), submit_time=t,
                                        hold_time=1.0))
        belief = np.zeros(64)
        belief[[3, 9, 17]] = 0.3
        res = svc.run(reqs, failures=[(6.0, [3]), (14.0, [9])],
                      recoveries=[(20.0, [3, 9])],
                      heartbeat_interval=0.5, belief=belief,
                      belief_jitter=0.3)
        assert res.metrics.completed == 120
        assert res.hit_rate >= 0.90

    def test_invalid_drain_interval(self):
        with pytest.raises(ValueError):
            PlacementService(TorusTopology((3, 3, 3)), drain_interval=0.0,
                             device="cpu")


# ---------------------------------------------------------------------------
# arrival validation + duration cap (the port's arrivals)
# ---------------------------------------------------------------------------

class TestArrivalValidation:
    def test_poisson_rejects_bad_inputs(self):
        f = mixed_size_factory((8,))
        rng = np.random.default_rng(0)
        for bad in (0.0, -1.0, math.inf, math.nan):
            with pytest.raises(ValueError, match="rate"):
                poisson_stream(f, bad, 5, rng)
        with pytest.raises(ValueError, match="n_jobs"):
            poisson_stream(f, 1.0, 0, rng)
        with pytest.raises(ValueError, match="max_duration"):
            poisson_stream(f, 1.0, 5, rng, max_duration=0.0)

    def test_poisson_duration_cap(self):
        f = mixed_size_factory((8,))
        specs = poisson_stream(f, rate=10.0, n_jobs=500,
                               rng=np.random.default_rng(0),
                               max_duration=5.0)
        assert 0 < len(specs) < 500
        assert all(s.submit_time <= 5.0 for s in specs)
        full = poisson_stream(f, rate=10.0, n_jobs=500,
                              rng=np.random.default_rng(0))
        assert [s.submit_time for s in specs] == \
            [s.submit_time for s in full[:len(specs)]]

    def test_empty_stream_errors(self):
        with pytest.raises(ValueError, match="at least one"):
            serial_stream([])
        with pytest.raises(ValueError, match="at least one"):
            burst_stream([])
        with pytest.raises(ValueError, match="instant"):
            burst_stream([npb_dt_like(4)], at=-1.0)
        with pytest.raises(ValueError, match="at least one size"):
            mixed_size_factory(())
        with pytest.raises(ValueError, match="weights"):
            mixed_size_factory((4, 8), weights=(1.0,))


# ---------------------------------------------------------------------------
# scheduler admission counters (the port's scheduler)
# ---------------------------------------------------------------------------

class TestSchedulerStats:
    def test_admission_counters(self):
        topo = TorusTopology((2, 2, 2))     # 8 nodes
        sch = Scheduler(topo, seed=0, device="cpu")
        sch.clock = 0.0
        first = sch.submit(Job(npb_dt_like(8)))
        assert first.state == "running" and first.start_time == 0.0
        sch.clock = 1.0
        second = sch.submit(Job(npb_dt_like(4)))
        s = sch.stats()
        assert s["queue_depth"] == 1 and s["peak_queue_depth"] == 1
        assert s["n_enqueued"] == 2 and s["n_started"] == 1
        sch.clock = 3.0
        sch.complete(first.job.job_id)
        s = sch.stats()
        assert second.state == "running"
        assert second.enqueue_time == 1.0 and second.start_time == 3.0
        assert s["queue_depth"] == 0 and s["n_started"] == 2
        assert s["admission_wait_max_s"] == pytest.approx(2.0)
        assert s["admission_wait_mean_s"] == pytest.approx(1.0)

    def test_clustersim_drives_clock(self):
        from repro_torch.sim.clustersim import ClusterSim, SimConfig
        from repro_torch.workloads.arrivals import JobSpec
        topo = TorusTopology((3, 3, 3))
        sch = Scheduler(topo, seed=0, device="cpu")
        jobs = [JobSpec(npb_dt_like(8), submit_time=float(i))
                for i in range(4)]
        ClusterSim(sch, jobs, config=SimConfig()).run()
        s = sch.stats()
        assert s["n_enqueued"] == 4 and s["n_started"] == 4
        assert s["admission_wait_total_s"] >= 0.0
        assert sch.clock > 0.0


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _ref_storm_rows(ref_storm, cfg):
    """The reference's service over its own storm stream and churn, per
    policy: (row, placement log)."""
    topo = RefTorus(cfg["dims"])
    _, belief, failures, recoveries = ref_storm.build_churn(
        topo, n_flaky=cfg["n_flaky"], seed=cfg["seed"],
        horizon=cfg["n_req"] / cfg["rate"] + 60.0, churn_every=5.0,
        repair_after=15.0, per_event=cfg["per_event"])
    out = {}
    for policy in ("tofa", "linear"):
        svc = RefService(topo, policy=policy, seed=cfg["seed"],
                         drain_interval=0.25, restart_delay=1.0)
        res = svc.run(ref_storm.build_stream(cfg["n_req"], cfg["rate"],
                                             cfg["seed"]),
                      failures=failures, recoveries=recoveries,
                      heartbeat_interval=0.5, belief=belief,
                      belief_jitter=0.3)
        out[policy] = (res.row, res.placement_log)
    return out


def test_fast_storm_equals_reference(chip_smoke, ref_storm):
    """The fast storm (4x4x4, 150 requests at 5/s, 8 flaky nodes, one per
    event) through the port on the CPU and through the reference: every
    simulated field of each policy's row and the placement log equal."""
    cfg = chip_smoke.STORM_FAST
    want = _ref_storm_rows(ref_storm, cfg)
    got = chip_smoke.run_storm(cfg, device="cpu")
    for policy in ("tofa", "linear"):
        res = got[policy]
        row, log = want[policy]
        assert chip_smoke.simulated(res.row) == chip_smoke.simulated(row), \
            policy
        assert [n for _, n in res.placement_log] == [n for _, n in log]
        assert res.row["placed"] == cfg["n_req"]
    assert got["tofa"].row["hit_rate"] >= 0.90


def test_expected_storm_is_the_reference(chip_smoke, ref_storm):
    """``chip_smoke.EXPECTED_STORM`` is what the reference's service on its
    NumPy engine returns for the full storm (6x6x6, 600 requests)."""
    want = _ref_storm_rows(ref_storm, chip_smoke.STORM_FULL)
    for policy, (row, _) in want.items():
        assert chip_smoke.simulated(row) == \
            chip_smoke.EXPECTED_STORM[policy], policy


def test_storm_stream_and_churn_equal_reference(chip_smoke, ref_storm):
    """``chip_smoke.py``'s copy of ``build_stream`` and ``build_churn``
    gives the reference's arrivals, shapes, SLOs and churn schedule."""
    cfg = chip_smoke.STORM_FULL
    mine = chip_smoke.build_stream(cfg["n_req"], cfg["rate"], cfg["seed"])
    ref = ref_storm.build_stream(cfg["n_req"], cfg["rate"], cfg["seed"])
    assert [(r.submit_time, r.deadline, int(r.slo), r.n_ranks)
            for r in mine] == [(r.submit_time, r.deadline, int(r.slo),
                                r.n_ranks) for r in ref]
    assert all(np.array_equal(a.workload.comm.G_v, b.workload.comm.G_v)
               for a, b in zip(mine, ref))
    kw = dict(n_flaky=cfg["n_flaky"], seed=cfg["seed"], horizon=120.0,
              churn_every=5.0, repair_after=15.0,
              per_event=cfg["per_event"])
    a = chip_smoke.build_churn(TorusTopology(cfg["dims"]), **kw)
    b = ref_storm.build_churn(RefTorus(cfg["dims"]), **kw)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[2:] == b[2:]


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_kv_shard_bytes_equal_reference(name):
    cfg, ref_cfg = get_arch(name), REF_ARCHS[name]
    for shards in (1, 3):
        assert kv_shard_bytes(cfg, 8, 4096, shards=shards) == \
            ref_kv_shard_bytes(ref_cfg, 8, 4096, shards=shards)


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-2.7b"])
def test_analytic_cache_bytes_equal_schema(name):
    """The arithmetic fallback agrees with the exact schema for the two
    families the port serves."""
    cfg = get_arch(name)
    assert _analytic_cache_bytes(cfg, 8, 4096) == \
        kv_shard_bytes(cfg, 8, 4096)


def test_service_targets_the_card(monkeypatch):
    """Without ``device`` (or an engine) the service builds its engine on
    ``cuda``: with no GPU it raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    with pytest.raises(backend.BackendUnavailableError):
        PlacementService(TorusTopology((3, 3, 3)))
    svc = PlacementService(TorusTopology((3, 3, 3)), device="cpu")
    assert svc.engine.backend.device.type == "cpu"
