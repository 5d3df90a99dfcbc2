"""Mapping parity: the torch backend against the reference's NumPy kernels.

The port's ``mapping_torch`` is held to ``repro.core.mapping`` on its
default numpy backend — never to the reference's jax float64 backend,
which is unavailable on the installed jax.  At float64 the guest
weights and distances are exact integers, so refined placements must be
**bit-identical** and hop-bytes agree to rtol 1e-9 (the contract of
``tests/test_backend_diff.py``).  At float32 summation order may differ,
so against NumPy only valid integer placements within rtol 1e-3 of its
hop-bytes are required; against the reference's jax float32 backend (run
in a subprocess) placements must be equal, the one recorded exception
held to 1.05x its hop-bytes.  Everything runs on the CPU with the plain
PyTorch kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core.fattree import FatTreeTopology as RefFatTree  # noqa: E402
from repro.core.topology import TorusTopology as RefTorus  # noqa: E402
from repro.workloads.patterns import (alltoall_heavy, lammps_like,  # noqa
                                      npb_dt_like)
from repro_torch import interop  # noqa: E402
from repro_torch.core import backend, mapping  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors: intra-op threads only contend across workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-9


def _use_torch(dtype="float64"):
    return backend.use("torch", dtype=dtype, device="cpu")


def _hosts():
    """(name, reference topology, port topology) pairs."""
    return [("torus", RefTorus((4, 4, 4)),
             interop.topology(torus_dims=(4, 4, 4))),
            ("fattree", RefFatTree(8), interop.topology(fattree_k=8))]


def _p_f(n_nodes: int, seed: int = 5, count: int = 6) -> np.ndarray:
    p_f = np.zeros(n_nodes)
    p_f[np.random.default_rng(seed).choice(n_nodes, count,
                                           replace=False)] = 0.1
    return p_f


def _weights(topo, faulty: bool) -> np.ndarray:
    return topo.weight_matrix(_p_f(topo.n_nodes)) if faulty \
        else topo.hop_matrix()


@pytest.mark.parametrize("name,ref_topo,topo", _hosts())
@pytest.mark.parametrize("faulty", [False, True])
def test_hop_bytes_parity(name, ref_topo, topo, faulty):
    G = npb_dt_like(40).comm.G_v
    D_ref, D = _weights(ref_topo, faulty), _weights(topo, faulty)
    np.testing.assert_array_equal(D, D_ref)
    rng = np.random.default_rng(0)
    P = np.stack([rng.permutation(topo.n_nodes)[:40] for _ in range(5)])
    want = ref_mapping.hop_bytes_batch(G, D_ref, P)
    with _use_torch():
        got = mapping.hop_bytes_batch(G, D, P)
        one = mapping.hop_bytes(G, D, P[0])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(one, want[0], rtol=RTOL)


@pytest.mark.parametrize("name,ref_topo,topo", _hosts())
@pytest.mark.parametrize("faulty", [False, True])
def test_refine_identical(name, ref_topo, topo, faulty):
    G = npb_dt_like(40).comm.G_v
    D_ref, D = _weights(ref_topo, faulty), _weights(topo, faulty)
    rng = np.random.default_rng(1)
    P = np.stack([rng.permutation(topo.n_nodes)[:40] for _ in range(3)])
    want = ref_mapping.refine_batch(G, D_ref, P)
    with _use_torch():
        got = mapping.refine_batch(G, D, P)
        single = mapping._pairwise_refine(G, D, P[0])
    assert got.dtype.kind == "i"
    assert np.array_equal(got, want), f"{name} faulty={faulty}"
    assert np.array_equal(single, want[0])


def test_dense_guest_refine_identical():
    """alltoall_heavy(40) is denser than half-full: the dense branch,
    whose select step is the swap_select kernel, serves it."""
    from repro_torch.core import mapping_torch
    G = alltoall_heavy(40).comm.G_v
    be = backend.get_backend("torch", device="cpu")
    assert mapping_torch._guest_device(G, 64, be)[2] is not None  # dense
    D = interop.topology(torus_dims=(4, 4, 4)).weight_matrix(_p_f(64))
    rng = np.random.default_rng(2)
    P = np.stack([rng.permutation(64)[:40] for _ in range(4)])
    want = ref_mapping.refine_batch(G, D, P)
    with _use_torch():
        got = mapping.refine_batch(G, D, P)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("health", ["healthy", "faults", "stragglers",
                                    "both"])
def test_fattree_lazy_refine_identical(health):
    """Implicit fat-tree metric (coords + penalty row) in every health
    state, bit-identical to the NumPy kernels on the reference adapter."""
    n_nodes = 128
    p_f = strag = None
    if health in ("faults", "both"):
        p_f = _p_f(n_nodes)
    if health in ("stragglers", "both"):
        strag = np.zeros(n_nodes)
        strag[np.random.default_rng(9).choice(n_nodes, 5,
                                              replace=False)] = 1.5
    D_ref = RefFatTree(8).lazy_distance(p_f, c=2.0, straggler=strag)
    D = interop.topology(fattree_k=8).lazy_distance(p_f, c=2.0,
                                                    straggler=strag)
    assert D.implicit is not None
    G = npb_dt_like(40).comm.G_v
    rng = np.random.default_rng(1)
    P = np.stack([rng.permutation(n_nodes)[:40] for _ in range(3)])
    want = ref_mapping.refine_batch(G, D_ref, P)
    hb_want = ref_mapping.hop_bytes_batch(G, D_ref, want)
    with _use_torch():
        got = mapping.refine_batch(G, D, P)
        hb = mapping.hop_bytes_batch(G, D, got)
    assert np.array_equal(got, want), health
    np.testing.assert_allclose(hb, hb_want, rtol=RTOL)


def test_implicit_torus_refine_identical():
    """Healthy lazy torus: distances from coordinates, never a matrix."""
    dims = (6, 6, 4)
    G = npb_dt_like(64, seed=3).comm.weights("volume")
    D_ref = RefTorus(dims).hop_matrix()
    D = interop.topology(torus_dims=dims).lazy_distance()
    assert D.implicit is not None
    rng = np.random.default_rng(0)
    P = np.stack([rng.permutation(144)[:64] for _ in range(4)])
    want = ref_mapping.refine_batch(G, D_ref, P)
    hb_want = ref_mapping.hop_bytes_batch(G, D_ref, P)
    with _use_torch():
        got = mapping.refine_batch(G, D, P)
        hb = mapping.hop_bytes_batch(G, D, P)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(hb, hb_want, rtol=RTOL)


def test_faulty_lazy_torus_takes_numpy_kernels():
    """A fault-weighted lazy torus has no implicit spec: the dispatch runs
    the NumPy kernels against the adapter (a problem type the device
    kernels do not serve), matching the reference exactly."""
    from repro_torch.core import mapping_torch
    dims = (6, 6, 4)
    p_f = _p_f(144)
    D = interop.topology(torus_dims=dims).lazy_distance(p_f)
    assert not mapping_torch.lazy_supported(D)
    G = npb_dt_like(48, seed=3).comm.G_v
    rng = np.random.default_rng(0)
    P = np.stack([rng.permutation(144)[:48] for _ in range(2)])
    want = ref_mapping.refine_batch(G, RefTorus(dims).lazy_distance(p_f), P)
    with _use_torch():
        assert mapping._torch_kernels(G, D) is None
        got = mapping.refine_batch(G, D, P)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,ref_topo,topo", _hosts())
def test_select_nodes_identical(name, ref_topo, topo):
    W_ref, W = _weights(ref_topo, True), _weights(topo, True)
    for count in (5, 17, 33):
        with _use_torch():
            got = mapping.select_nodes(W, count)
            seeded = mapping.select_nodes(W, count, seed=3)
        assert np.array_equal(got, ref_mapping.select_nodes(W_ref, count))
        assert np.array_equal(seeded,
                              ref_mapping.select_nodes(W_ref, count, seed=3))


@pytest.mark.parametrize("name,ref_topo,topo", _hosts())
@pytest.mark.parametrize("wl_fn", [npb_dt_like, lammps_like])
def test_greedy_placement_identical(name, ref_topo, topo, wl_fn):
    G = wl_fn(24).comm.G_v
    want = ref_mapping.greedy_placement(G, np.arange(topo.n_nodes),
                                        ref_topo.hop_matrix())
    with _use_torch():
        got = mapping.greedy_placement(G, np.arange(topo.n_nodes),
                                       topo.hop_matrix())
    assert np.array_equal(got, want)


def test_greedy_placement_partial_nodes():
    """Restricted availability: the frontier only hands out listed nodes."""
    topo = interop.topology(torus_dims=(4, 4, 4))
    nodes = np.arange(5, 64, 2)
    G = npb_dt_like(24).comm.G_v
    want = ref_mapping.greedy_placement(G, nodes, RefTorus((4, 4, 4))
                                        .hop_matrix())
    with _use_torch():
        got = mapping.greedy_placement(G, nodes, topo.hop_matrix())
    assert np.array_equal(got, want)
    assert set(got.tolist()) <= set(nodes.tolist())


@pytest.mark.parametrize("name,ref_topo,topo", _hosts())
def test_float32_valid_and_close(name, ref_topo, topo):
    G = npb_dt_like(40).comm.G_v
    D = _weights(topo, True)
    rng = np.random.default_rng(1)
    P = np.stack([rng.permutation(topo.n_nodes)[:40] for _ in range(3)])
    want = ref_mapping.refine_batch(G, _weights(ref_topo, True), P)
    with _use_torch("float32"):
        got = mapping.refine_batch(G, D, P)
        hb32 = mapping.hop_bytes_batch(G, D, P)
    assert got.dtype.kind == "i"
    for row in got:
        assert len(set(row.tolist())) == 40
    np.testing.assert_allclose(ref_mapping.hop_bytes_batch(G, D, got),
                               ref_mapping.hop_bytes_batch(G, D, want),
                               rtol=1e-3)
    np.testing.assert_allclose(hb32, ref_mapping.hop_bytes_batch(G, D, P),
                               rtol=1e-3)


def test_reference_impl_wins_over_torch_backend():
    """use_reference_impl runs the scalar loops regardless of backend."""
    D = interop.topology(torus_dims=(4, 4, 4)).hop_matrix()
    G = npb_dt_like(24).comm.G_v
    P = np.stack([np.random.default_rng(s).permutation(64)[:24]
                  for s in range(2)])
    with ref_mapping.use_reference_impl():
        want = ref_mapping.refine_batch(G, D, P)
    with mapping.use_reference_impl():
        with _use_torch():
            got = mapping.refine_batch(G, D, P)
            assert mapping.greedy_placement is \
                mapping.greedy_placement_reference
    assert np.array_equal(got, want)
    assert mapping.greedy_placement is not mapping.greedy_placement_reference


def test_backend_refuses_lazy_densify():
    be = backend.get_backend("torch", device="cpu")
    D = interop.topology(torus_dims=(4, 4, 4)).lazy_distance()
    with pytest.raises(TypeError):
        be.device_matrix(D)


def test_device_matrix_lru_counts_transfers():
    be = backend.TorchBackend(device="cpu", max_cached_devices=2)
    a, b, c = (np.full((3, 3), float(v)) for v in range(3))
    be.device_matrix(a)
    assert be.device_matrix(a).dtype == torch.float64
    assert be.stats == {"transfers": 1, "transfer_hits": 1}
    be.device_matrix(b)
    be.device_matrix(c)                       # evicts a
    be.device_matrix(a)
    assert be.stats["transfers"] == 4
    f32 = backend.TorchBackend(dtype="float32", device="cpu")
    assert f32.device_matrix(a).dtype == torch.float32
    with pytest.raises(ValueError):
        backend.TorchBackend(dtype="float16", device="cpu")
    with pytest.raises(ValueError):
        backend.get_backend("tensorflow")


def test_entry_point_stats_count_calls():
    from repro_torch.core import mapping_torch
    D = interop.topology(torus_dims=(4, 4, 4)).hop_matrix()
    G = npb_dt_like(16).comm.G_v
    P = np.stack([np.random.default_rng(s).permutation(64)[:16]
                  for s in range(2)])
    mapping_torch.reset_stats()
    with _use_torch():
        mapping.refine_batch(G, D, P)
        mapping.hop_bytes_batch(G, D, P)
    stats = mapping_torch.STATS
    assert stats["refine_many"]["calls"] == 1
    assert stats["hop_bytes_batch"]["calls"] == 1
    assert stats["refine_many"]["s"] > 0.0
    assert stats["select_nodes"]["calls"] == 0
    mapping_torch.reset_stats()
    assert stats["refine_many"] == {"calls": 0, "s": 0.0}


# The float32 contract: the port's float32 kernels against the reference's
# jax float32 backend.  ``backend.use("jax", dtype="float32")`` rebinds a
# module global of the reference package, so the reference side runs in a
# subprocess and hands back its placements as JSON.
F32_CASES_PROGRAM = """\
import json
import numpy as np
from repro.core import backend, mapping
from repro.core.fattree import FatTreeTopology
from repro.core.topology import TorusTopology
from repro.workloads.patterns import alltoall_heavy, lammps_like, npb_dt_like

def p_f(n):
    out = np.zeros(n)
    out[np.random.default_rng(5).choice(n, 6, replace=False)] = 0.1
    return out

out = {}
with backend.use("jax", dtype="float32"):
    for name, topo in (("torus", TorusTopology((4, 4, 4))),
                       ("fattree", FatTreeTopology(8))):
        G = npb_dt_like(40).comm.G_v
        for faulty in (False, True):
            D = topo.weight_matrix(p_f(topo.n_nodes)) if faulty \\
                else topo.hop_matrix()
            rng = np.random.default_rng(1)
            P = np.stack([rng.permutation(topo.n_nodes)[:40]
                          for _ in range(3)])
            out[f"refine/{name}/{faulty}"] = mapping.refine_batch(G, D, P)
        W = topo.weight_matrix(p_f(topo.n_nodes))
        for count in (5, 17, 33):
            for seed in (None, 3):
                out[f"select/{name}/{count}/{seed}"] = \\
                    mapping.select_nodes(W, count, seed=seed)
        for wl in ("npb_dt_like", "lammps_like"):
            out[f"greedy/{name}/{wl}"] = mapping.greedy_placement(
                globals()[wl](24).comm.G_v, np.arange(topo.n_nodes),
                topo.hop_matrix())
    topo = TorusTopology((4, 4, 4))
    rng = np.random.default_rng(2)
    P = np.stack([rng.permutation(64)[:40] for _ in range(4)])
    out["refine/dense-alltoall/True"] = mapping.refine_batch(
        alltoall_heavy(40).comm.G_v, topo.weight_matrix(p_f(64)), P)
print(json.dumps({k: np.asarray(v).tolist() for k, v in out.items()}))
"""


def _reference_subprocess(program: str) -> dict:
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", program], capture_output=True,
                         text=True, env=env, timeout=600, check=True)
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def jax_f32_placements():
    return _reference_subprocess(F32_CASES_PROGRAM)


def _port_f32_case(key: str) -> np.ndarray:
    kind, name = key.split("/")[:2]
    topo = interop.topology(torus_dims=(4, 4, 4)) \
        if name in ("torus", "dense-alltoall") \
        else interop.topology(fattree_k=8)
    with _use_torch("float32"):
        if kind == "refine":
            faulty = key.endswith("True")
            D = _weights(topo, faulty)
            if name == "dense-alltoall":
                rng = np.random.default_rng(2)
                P = np.stack([rng.permutation(64)[:40] for _ in range(4)])
                return mapping.refine_batch(alltoall_heavy(40).comm.G_v, D,
                                            P)
            rng = np.random.default_rng(1)
            P = np.stack([rng.permutation(topo.n_nodes)[:40]
                          for _ in range(3)])
            return mapping.refine_batch(npb_dt_like(40).comm.G_v, D, P)
        if kind == "select":
            count, seed = key.split("/")[2:]
            return mapping.select_nodes(
                _weights(topo, True), int(count),
                seed=None if seed == "None" else int(seed))
        wl = {"npb_dt_like": npb_dt_like, "lammps_like": lammps_like}[
            key.split("/")[2]]
        return mapping.greedy_placement(wl(24).comm.G_v,
                                        np.arange(topo.n_nodes),
                                        topo.hop_matrix())


F32_KEYS = ([f"refine/{h}/{f}" for h in ("torus", "fattree")
             for f in (False, True)] + ["refine/dense-alltoall/True"]
            + [f"select/{h}/{c}/{s}" for h in ("torus", "fattree")
               for c in (5, 17, 33) for s in (None, 3)]
            + [f"greedy/{h}/{w}" for h in ("torus", "fattree")
               for w in ("npb_dt_like", "lammps_like")])


# The one request whose float32 placements differ from the reference's
# jax float32 ones (ROADMAP section 3): the all-to-all guest has many swaps
# of equal gain, and float32 rounding of the 1e9-scale fault weights picks
# others among them.  Each row's hop-bytes (scored at float64) equal the
# reference's; the contract holds it to the cross-backend bound of
# tests/test_backend_diff.py, 1.05x.
F32_DIFFERS = {"refine/dense-alltoall/True"}


@pytest.mark.parametrize("key", F32_KEYS)
def test_float32_equals_reference_jax(jax_f32_placements, key):
    """At float32 the port's placements equal the reference's jax float32
    backend's on these requests, except ``F32_DIFFERS``: valid placements
    within 1.05x of the reference's hop-bytes."""
    got = _port_f32_case(key)
    want = np.asarray(jax_f32_placements[key])
    assert got.dtype.kind == "i"
    if key not in F32_DIFFERS:
        assert np.array_equal(got, want), key
        return
    assert not np.array_equal(got, want)      # still differs: update docs
    G = alltoall_heavy(40).comm.G_v
    D = _weights(interop.topology(torus_dims=(4, 4, 4)), True)
    for row in got:
        assert len(set(row.tolist())) == 40
    assert (ref_mapping.hop_bytes_batch(G, D, got)
            <= 1.05 * ref_mapping.hop_bytes_batch(G, D, want)).all()
