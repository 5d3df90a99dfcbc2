"""Engine parity: the port's PlacementEngine against the reference's.

Both engines place the same job — the port's request built through
``repro_torch.interop`` from the reference's arrays — and must return
identical placements: the reference on its NumPy backend, the port on its
torch backend with the plain PyTorch kernels (``device="cpu"``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import PlacementEngine as RefEngine  # noqa: E402
from repro.core.engine import PlacementRequest as RefRequest  # noqa: E402
from repro.core.fattree import FatTreeTopology as RefFatTree  # noqa: E402
from repro.core.state import ClusterState as RefState  # noqa: E402
from repro.core.state import NodeHealth  # noqa: E402
from repro.core.topology import TorusTopology as RefTorus  # noqa: E402
from repro.workloads.patterns import npb_dt_like  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.core.engine import PlacementEngine  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors: intra-op threads only contend across workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-9
HOSTS = [("torus", RefTorus((4, 4, 4)), dict(torus_dims=(4, 4, 4))),
         ("fattree", RefFatTree(8), dict(fattree_k=8))]


def _p_f(n_nodes: int) -> np.ndarray:
    p_f = np.zeros(n_nodes)
    p_f[np.random.default_rng(5).choice(n_nodes, 6, replace=False)] = 0.1
    return p_f


def _pair(ref_topo, host_kw, n: int, faulty: bool):
    """(reference request, port request) for the same job."""
    wl = npb_dt_like(n)
    p_f = _p_f(ref_topo.n_nodes) if faulty else None
    ref = RefRequest(comm=wl.comm, topology=ref_topo, p_f=p_f)
    port = interop.request(wl.comm.G_v, wl.comm.G_m, p_f=p_f, **host_kw)
    return ref, port


def _engine(**kw):
    return PlacementEngine(device="cpu", **kw)


@pytest.mark.parametrize("name,ref_topo,host_kw", HOSTS)
@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("policy", ["linear", "greedy", "topo", "tofa",
                                    "tofa-ml"])
def test_policy_placements_identical(name, ref_topo, host_kw, faulty,
                                     policy):
    ref_req, req = _pair(ref_topo, host_kw, 24, faulty)
    want = RefEngine().place(ref_req, policy=policy,
                             rng=np.random.default_rng(0))
    got = _engine().place(req, policy=policy, rng=np.random.default_rng(0))
    assert np.array_equal(got.placement, want.placement), \
        f"{name} faulty={faulty} {policy}"
    assert got.placement.dtype.kind == "i"
    np.testing.assert_allclose(got.hop_bytes, want.hop_bytes, rtol=RTOL)
    assert got.faulty_nodes_used == want.faulty_nodes_used
    assert got.used_consecutive_window == want.used_consecutive_window


def test_multilevel_chunks_identical():
    """tofa-ml above its coarse target runs multilevel with per-chunk
    refines and a final batched refine — all on the port's kernels."""
    topo = RefTorus((8, 8, 4))
    wl = npb_dt_like(200, seed=3)
    p_f = np.zeros(topo.n_nodes)
    p_f[np.random.default_rng(7).choice(topo.n_nodes, 8, replace=False)] = .02
    want = RefEngine().place(RefRequest(comm=wl.comm, topology=topo,
                                        p_f=p_f),
                             policy="tofa-ml", rng=np.random.default_rng(0))
    req = interop.request(wl.comm.G_v, wl.comm.G_m, torus_dims=(8, 8, 4),
                          p_f=p_f)
    got = _engine().place(req, policy="tofa-ml",
                          rng=np.random.default_rng(0))
    assert np.array_equal(got.placement, want.placement)


@pytest.mark.parametrize("name,ref_topo,host_kw", HOSTS)
def test_lazy_threshold_zero_identical(name, ref_topo, host_kw):
    """Every topology served lazily: the implicit device path (healthy
    torus, fat-tree) against the reference's NumPy lazy path."""
    ref_req, req = _pair(ref_topo, host_kw, 24, faulty=(name == "fattree"))
    want = RefEngine(lazy_threshold=0).place(ref_req, policy="tofa",
                                             rng=np.random.default_rng(0))
    got = _engine(lazy_threshold=0).place(req, policy="tofa",
                                          rng=np.random.default_rng(0))
    assert np.array_equal(got.placement, want.placement)
    np.testing.assert_allclose(got.hop_bytes, want.hop_bytes, rtol=RTOL)


def test_place_many_equals_sequential():
    jobs = [(12, False), (24, True), (18, False), (12, True)]
    reqs = [_pair(RefTorus((4, 4, 4)), dict(torus_dims=(4, 4, 4)), n, f)[1]
            for n, f in jobs]
    engine = _engine()
    seq = [engine.place(r, policy="tofa") for r in reqs]
    batch = _engine().place_many(reqs, policy="tofa")
    for s, b in zip(seq, batch):
        assert np.array_equal(s.placement, b.placement)
        assert s.hop_bytes == b.hop_bytes


def test_state_churn_identical_with_no_new_transfers():
    """Placements through a health-churn sequence match the reference,
    and a warm re-placement against the last epoch transfers nothing."""
    topo = RefTorus((4, 4, 4))
    wl = npb_dt_like(16)
    churn = [RefState.healthy(64).with_outage(
        np.where(np.arange(64) < 5, 0.1, 0.0))]
    for ids in ([7], [9, 33], [12]):
        churn.append(churn[-1].with_health(ids, NodeHealth.DOWN))
    states = [interop.cluster_state(s.health, s.p_f) for s in churn]
    ref_engine, engine = RefEngine(), _engine()
    be = backend.get_backend("torch", device="cpu")
    for ref_s, s in zip(churn, states):
        want = ref_engine.place(
            RefRequest(comm=wl.comm, topology=topo, state=ref_s),
            policy="tofa", rng=np.random.default_rng(0))
        got = engine.place(
            interop.request(wl.comm.G_v, wl.comm.G_m,
                            torus_dims=(4, 4, 4), state=s),
            policy="tofa", rng=np.random.default_rng(0))
        assert np.array_equal(got.placement, want.placement)
    transfers = be.stats["transfers"]
    engine.place(interop.request(wl.comm.G_v, wl.comm.G_m,
                                 torus_dims=(4, 4, 4), state=states[-1]),
                 policy="tofa", rng=np.random.default_rng(1))
    assert be.stats["transfers"] == transfers


def test_replace_identical():
    ref_req, req = _pair(RefTorus((4, 4, 4)), dict(torus_dims=(4, 4, 4)),
                         24, faulty=True)
    ref_engine, engine = RefEngine(), _engine()
    want = ref_engine.place(ref_req, rng=np.random.default_rng(0))
    got = engine.place(req, rng=np.random.default_rng(0))
    victims = want.placement[:2]
    want2 = ref_engine.replace(want, failed_nodes=victims)
    got2 = engine.replace(got, failed_nodes=victims)
    assert np.array_equal(got2.placement, want2.placement)
    assert got2.provenance == want2.provenance == "replace-incremental"


def test_committed_bench_hop_bytes():
    """torus-8x8x8/n256/healthy reproduces the committed tofa hop-bytes
    (benchmarks/BENCH_mapping.json, last trajectory point)."""
    wl = npb_dt_like(256, seed=3)
    req = interop.request(wl.comm.G_v, wl.comm.G_m, torus_dims=(8, 8, 8))
    plan = _engine().place(req, policy="tofa", rng=np.random.default_rng(0))
    assert plan.hop_bytes == 18316800000.0


def test_engine_backend_kwargs(monkeypatch):
    eng = _engine()
    assert eng.backend.name == "torch" and eng.backend.device.type == "cpu"
    assert eng.backend.dtype == "float64"
    assert PlacementEngine(backend="numpy").backend.name == "numpy"
    with pytest.raises(ValueError):
        PlacementEngine(backend=None, device="cpu")
    # no scope leaked: outside every scope the default is the card again
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    with pytest.raises(backend.BackendUnavailableError):
        backend.active()


def test_float32_engine_valid_placement():
    """A float32 torch backend (set by scope, the engine following it)
    returns valid integer placements close to the float64 quality."""
    ref_req, req = _pair(RefTorus((4, 4, 4)), dict(torus_dims=(4, 4, 4)),
                         24, faulty=True)
    want = RefEngine().place(ref_req, rng=np.random.default_rng(0))
    with backend.use("torch", dtype="float32", device="cpu"):
        plan = PlacementEngine(backend=None).place(
            req, rng=np.random.default_rng(0))
    assert plan.placement.dtype.kind == "i"
    assert len(set(plan.placement.tolist())) == 24
    assert plan.hop_bytes <= want.hop_bytes * 1.10
