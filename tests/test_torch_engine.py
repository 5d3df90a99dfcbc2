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


# The float32 contract of the engine: every policy's placement with the
# port's float32 torch backend equals the reference engine's on its jax
# float32 backend.  The reference side runs in a subprocess, since
# ``backend.use("jax", dtype="float32")`` rebinds a module global of the
# reference package.
F32_ENGINE_PROGRAM = """\
import json
import numpy as np
from repro.core import backend
from repro.core.engine import PlacementEngine, PlacementRequest
from repro.core.fattree import FatTreeTopology
from repro.core.topology import TorusTopology
from repro.workloads.patterns import npb_dt_like

out = {}
with backend.use("jax", dtype="float32"):
    for name, topo in (("torus", TorusTopology((4, 4, 4))),
                       ("fattree", FatTreeTopology(8))):
        for faulty in (False, True):
            p_f = None
            if faulty:
                p_f = np.zeros(topo.n_nodes)
                p_f[np.random.default_rng(5).choice(
                    topo.n_nodes, 6, replace=False)] = 0.1
            req = PlacementRequest(comm=npb_dt_like(24).comm, topology=topo,
                                   p_f=p_f)
            for policy in ("linear", "greedy", "topo", "tofa", "tofa-ml"):
                plan = PlacementEngine().place(req, policy=policy,
                                               rng=np.random.default_rng(0))
                out[f"{name}/{faulty}/{policy}"] = [
                    np.asarray(plan.placement).tolist(), plan.hop_bytes]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_f32_plans():
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", F32_ENGINE_PROGRAM],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    return json.loads(out.stdout)


@pytest.mark.parametrize("name,ref_topo,host_kw", HOSTS)
@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("policy", ["linear", "greedy", "topo", "tofa",
                                    "tofa-ml"])
def test_float32_engine_equals_reference_jax(jax_f32_plans, name, ref_topo,
                                             host_kw, faulty, policy):
    _, req = _pair(ref_topo, host_kw, 24, faulty)
    with backend.use("torch", dtype="float32", device="cpu"):
        plan = PlacementEngine(backend=None).place(
            req, policy=policy, rng=np.random.default_rng(0))
    placement, hop_bytes = jax_f32_plans[f"{name}/{faulty}/{policy}"]
    assert np.array_equal(plan.placement, placement)
    np.testing.assert_allclose(plan.hop_bytes, hop_bytes, rtol=1e-6)


def _paper_fast_batch0(lammps):
    """The request of ``paper-fig4-5``'s first batch at ``fast=True``
    (4x4x4 torus, 8 faulty candidates at p_f 0.02, seed 0) for the guest
    ``lammps``, and the preset's placement RNG for it."""
    from repro.cluster.failures import BernoulliPerJob

    candidates = np.random.default_rng(0).choice(64, 8, replace=False)
    p_f = BernoulliPerJob(candidates, 0.02).outage_vector(64)
    wl = lammps(27)
    return wl, p_f, np.random.default_rng(0)


@pytest.mark.parametrize("case", ["lammps-48-healthy",
                                  "lammps-27-paper-fast-batch0"])
def test_fractional_weight_guest_quality(case):
    """Guests with non-dyadic weights (``lammps_like`` all-reduce bytes
    over 27 or 48 ranks) may place differently under tofa on the torch
    backend than on NumPy: the sparse refine sums gains in another order.
    The reference's cross-backend contract holds such placements to 1.05x
    the NumPy engine's hop-bytes (tests/test_backend_diff.py)."""
    from repro.workloads.patterns import lammps_like as ref_lammps
    from repro_torch.workloads.patterns import lammps_like

    if case == "lammps-48-healthy":
        ref_wl, p_f, rng = ref_lammps(48), None, np.random.default_rng(0)
        wl, port_rng = lammps_like(48), np.random.default_rng(0)
    else:
        ref_wl, p_f, rng = _paper_fast_batch0(ref_lammps)
        wl, _, port_rng = _paper_fast_batch0(lammps_like)
    want = RefEngine().place(RefRequest(comm=ref_wl.comm,
                                        topology=RefTorus((4, 4, 4)),
                                        p_f=p_f), policy="tofa", rng=rng)
    got = _engine().place(interop.request(wl.comm.G_v, wl.comm.G_m,
                                          torus_dims=(4, 4, 4), p_f=p_f),
                          policy="tofa", rng=port_rng)
    assert len(set(got.placement.tolist())) == wl.n_ranks
    assert got.faulty_nodes_used == want.faulty_nodes_used
    assert got.hop_bytes <= want.hop_bytes * 1.05


def test_default_engine_keyed_by_resolved_device():
    """Every spelling of one device returns the one shared engine."""
    from repro_torch.core.engine import default_engine

    eng = default_engine("cpu")
    assert default_engine(torch.device("cpu")) is eng
    assert default_engine("cpu") is eng
    assert eng.backend.device.type == "cpu"
