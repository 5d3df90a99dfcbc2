"""The port's ``core/placement.py`` and ``core/profiler.py`` against the
reference's.

``Fabric``'s hop, weight and coordinate arrays equal the reference's;
``assign_devices`` and ``compare_policies`` with the port's engine on
``device="cpu"`` (float64) return the reference NumPy engine's placements
and hop-bytes, dense guests (the ``swap_select`` branch) included; and
the port's HLO parser gives the reference's FLOPs, bytes, collectives and
communication graph on ``tests/test_profiler.py``'s synthetic module and
on a four-device program compiled with JAX in a subprocess.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import placement as R_pl  # noqa: E402
from repro.core import profiler as R_prof  # noqa: E402
from repro.core.engine import PlacementEngine as RefEngine  # noqa: E402
from repro.core.state import ClusterState as RefState  # noqa: E402
from repro.core.state import NodeHealth as RefHealth  # noqa: E402
from repro.workloads import patterns as R_pat  # noqa: E402

from repro_torch.core import backend, profiler  # noqa: E402
from repro_torch.core.engine import PlacementEngine  # noqa: E402
from repro_torch.core.placement import (Fabric, assign_devices,  # noqa
                                        compare_policies)
from repro_torch.core.state import ClusterState, NodeHealth  # noqa: E402
from repro_torch.kernels.swap_gain import ops as swap_ops  # noqa: E402
from repro_torch.workloads import patterns  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors: intra-op threads only contend across workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FABRICS = [((4, 4), 1), ((4, 4), 2), ((2, 2, 2), 3)]


@pytest.mark.parametrize("pod_dims,n_pods", FABRICS)
def test_fabric_arrays_equal_reference(pod_dims, n_pods):
    got, want = Fabric(pod_dims, n_pods), R_pl.Fabric(pod_dims, n_pods)
    assert got.n_nodes == want.n_nodes == got.n_chips
    n = got.n_chips
    p_f = np.zeros(n)
    p_f[np.random.default_rng(1).choice(n, 3, replace=False)] = 0.1
    straggler = np.ones(n)
    straggler[n // 3] = 2.5
    assert np.array_equal(got.hop_matrix(), want.hop_matrix())
    assert np.array_equal(got.coords_array(), want.coords_array())
    assert np.array_equal(got.weight_matrix(), want.weight_matrix())
    assert np.array_equal(got.weight_matrix(p_f), want.weight_matrix(p_f))
    assert np.array_equal(got.weight_matrix(p_f, straggler),
                          want.weight_matrix(p_f, straggler))


DEGRADED = (5, 21)


def _states():
    """(port state, reference state): a two-pod fabric's 32 chips with
    chips 5 and 21 DEGRADED at p_f 0.05."""
    p_f = np.zeros(32)
    p_f[list(DEGRADED)] = 0.05
    port = ClusterState.healthy(32).with_health(
        list(DEGRADED), NodeHealth.DEGRADED).with_outage(p_f)
    ref = RefState.healthy(32).with_health(
        list(DEGRADED), RefHealth.DEGRADED).with_outage(p_f)
    return port, ref


WORKLOADS = {
    "alltoall-16": lambda pat: pat.alltoall_heavy(16),
    "npb_dt-16": lambda pat: pat.npb_dt_like(16, seed=3),
    "lammps-8": lambda pat: pat.lammps_like(8),
}


@pytest.mark.parametrize("wl", sorted(WORKLOADS))
@pytest.mark.parametrize("health", ["degraded", "p_f", "healthy"])
def test_assign_and_compare_equal_reference(wl, health):
    got_wl, want_wl = WORKLOADS[wl](patterns), WORKLOADS[wl](R_pat)
    fab, ref_fab = Fabric((4, 4), 2), R_pl.Fabric((4, 4), 2)
    kw, ref_kw = {}, {}
    if health == "degraded":
        kw["state"], ref_kw["state"] = _states()
    elif health == "p_f":
        p_f = np.zeros(32)
        p_f[[3, 17, 30]] = 0.1
        kw["p_f"] = ref_kw["p_f"] = p_f
    got = compare_policies(got_wl.comm, fab,
                           engine=PlacementEngine(device="cpu"), **kw)
    want = R_pl.compare_policies(want_wl.comm, ref_fab,
                                 engine=RefEngine(backend="numpy"), **ref_kw)
    assert got == want
    a = assign_devices(got_wl.comm, fab, policy="tofa",
                       engine=PlacementEngine(device="cpu"),
                       rng=np.random.default_rng(0), **kw)
    b = R_pl.assign_devices(want_wl.comm, ref_fab, policy="tofa",
                            engine=RefEngine(backend="numpy"),
                            rng=np.random.default_rng(0), **ref_kw)
    assert np.array_equal(a.permutation, b.permutation)
    assert a.permutation.dtype.kind == "i"
    assert a.hop_bytes_linear == b.hop_bytes_linear
    assert a.hop_bytes_placed == b.hop_bytes_placed
    assert a.improvement == b.improvement
    assert a.plan.faulty_nodes_used == b.plan.faulty_nodes_used


def test_dense_guest_takes_the_swap_select_branch(monkeypatch):
    """``alltoall_heavy(16)`` has 15 partners a rank, over the dense
    threshold ``max(8, n_pad // 2)``: its tofa refine calls the
    ``swap_select`` entry point (the kernel on a GPU); NPB-DT does not."""
    from repro_torch.core import mapping_torch

    calls = []

    def counting(*a, **k):
        calls.append(1)
        return swap_ops.swap_select(*a, **k)

    monkeypatch.setattr(mapping_torch, "swap_select", counting)
    port_state, _ = _states()
    for wl, dense in (("alltoall-16", True), ("npb_dt-16", False)):
        calls.clear()
        assign_devices(WORKLOADS[wl](patterns).comm, Fabric((4, 4), 2),
                       engine=PlacementEngine(device="cpu"),
                       state=port_state, rng=np.random.default_rng(0))
        assert bool(calls) == dense, wl


def test_expected_fabric_is_the_reference():
    """``chip_smoke.EXPECTED_FABRIC`` is what the reference's NumPy engine
    returns for the fabric cells of the ``service`` phase."""
    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    assert tuple(chip_smoke.FABRIC_DEGRADED) == DEGRADED
    _, ref_state = _states()
    fab = R_pl.Fabric(pod_dims=(4, 4), n_pods=2)
    for cell, want in chip_smoke.EXPECTED_FABRIC.items():
        comm = WORKLOADS[cell](R_pat).comm
        report = R_pl.compare_policies(comm, fab, state=ref_state,
                                       engine=RefEngine(backend="numpy"))
        a = R_pl.assign_devices(comm, fab, policy="tofa", state=ref_state,
                                engine=RefEngine(backend="numpy"),
                                rng=np.random.default_rng(0))
        assert {p: r["hop_bytes"] for p, r in report.items()} == \
            want["compare"]
        assert a.hop_bytes_linear == want["hop_bytes_linear"]
        assert a.hop_bytes_placed == want["hop_bytes_placed"]


@pytest.mark.parametrize("cell", ["place/torus-32x32x16/npb_dt-512/implicit",
                                  "place/fattree-k32/npb_dt-512/faulty64"])
def test_expected_implicit_cell_is_the_reference(cell):
    """``chip_smoke.EXPECTED`` of each implicit placement cell is what the
    reference's NumPy engine returns for the request the cell builds."""
    from repro.core.engine import PlacementRequest as RefRequest
    from repro.core.fattree import FatTreeTopology as RefFatTree
    from repro.core.topology import TorusTopology as RefTorus

    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    comm = R_pat.npb_dt_like(512, seed=3).comm
    if "torus" in cell:
        req = RefRequest(comm=comm, topology=RefTorus((32, 32, 16)))
    else:
        topo = RefFatTree(32)
        req = RefRequest(comm=comm, topology=topo,
                         p_f=chip_smoke._faults(topo.n_nodes, 64))
    plan = RefEngine(backend="numpy").place(req, policy="tofa",
                                            rng=np.random.default_rng(0))
    assert plan.hop_bytes == chip_smoke.EXPECTED[cell]


def test_placement_targets_the_card(monkeypatch):
    """Without ``engine`` or ``device`` both entry points place on the
    shared default engine on ``cuda``: with no GPU they raise."""
    from repro_torch.core import engine as engine_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    monkeypatch.setattr(engine_mod, "_DEFAULT_ENGINES", {})
    comm = patterns.lammps_like(8).comm
    with pytest.raises(backend.BackendUnavailableError):
        assign_devices(comm, Fabric((4, 4), 1))
    with pytest.raises(backend.BackendUnavailableError):
        compare_policies(comm, Fabric((4, 4), 1))
    a = assign_devices(comm, Fabric((4, 4), 1), device="cpu")
    assert len(set(a.permutation.tolist())) == 8
    assert engine_mod.default_engine("cpu").backend.device.type == "cpu"


# ------------------------------------------------------------------ profiler
def _as_dict(prof) -> dict:
    return dataclasses.asdict(prof)


@pytest.fixture(scope="module")
def synth():
    return _load("test_profiler", ROOT / "tests" / "test_profiler.py").SYNTH


FOUR_DEVICE_PROGRAM = """\
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("x", "y"))
def step(ws, x):
    def layer(h, w):
        return jnp.tanh(h @ w), None
    h, _ = jax.lax.scan(layer, x, ws)
    return h.sum()
f = jax.jit(jax.grad(step),
            in_shardings=(NamedSharding(mesh, P(None, None, "y")),
                          NamedSharding(mesh, P("x", None))))
print(f.lower(jax.ShapeDtypeStruct((3, 16, 16), jnp.float32),
              jax.ShapeDtypeStruct((8, 16), jnp.float32)).compile().as_text())
"""


@pytest.fixture(scope="module")
def four_device_hlo():
    """HLO text of a scanned, sharded program compiled for four forced
    host devices (in a subprocess: the device count is fixed at JAX's
    start)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", FOUR_DEVICE_PROGRAM],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return out.stdout


def test_profile_synthetic_equals_reference(synth):
    got, want = profiler.profile_hlo(synth), R_prof.profile_hlo(synth)
    assert _as_dict(got) == _as_dict(want)
    assert got.flops == pytest.approx(128 * 12)
    assert got.collective_bytes == want.collective_bytes == 96 * 12
    assert got.collective_bytes_by_kind() == want.collective_bytes_by_kind()
    assert profiler.parse_replica_groups(
        "replica_groups=[4,2]<=[2,4]T(1,0)", 8) == \
        [(0, 4), (1, 5), (2, 6), (3, 7)]


def test_comm_graph_synthetic_equals_reference(synth):
    got = profiler.comm_graph_from_hlo(synth)
    want = R_prof.comm_graph_from_hlo(synth)
    assert got.n == want.n == 8
    assert np.array_equal(got.G_v, want.G_v)
    assert np.array_equal(got.G_m, want.G_m)


def test_profile_compiled_program_equals_reference(four_device_hlo):
    text = four_device_hlo
    got, want = profiler.profile_hlo(text), R_prof.profile_hlo(text)
    assert want.num_partitions == 4 and want.collectives
    assert _as_dict(got) == _as_dict(want)
    assert got.flops == want.flops > 0
    assert got.bytes_accessed == want.bytes_accessed > 0
    assert got.collective_bytes == want.collective_bytes > 0
    g, w = (profiler.comm_graph_from_hlo(text),
            R_prof.comm_graph_from_hlo(text))
    assert g.n == w.n == 4
    assert np.array_equal(g.G_v, w.G_v) and np.array_equal(g.G_m, w.G_m)
    assert g.G_v.sum() > 0
