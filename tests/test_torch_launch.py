"""The port's roofline arithmetic, dry-run stand-ins, H100 fabric and TOFA
mesh against the reference's ``repro.launch`` and its helpers.

* ``model_flops_for`` and ``ideal_attention_bytes`` equal the reference's
  exactly for every arch x live shape at 1, 256 and 512 devices, and the
  ``Roofline`` terms equal the reference's for the same inputs and
  constants (exactly);
* ``abstract_params`` / ``abstract_cache`` / ``input_specs`` give the
  reference's names, shapes and dtypes for every arch at full width and
  every live shape, as ``meta`` tensors (nemotron-4-340b's bytes sum to
  the reference's with nothing allocated);
* ``GpuFabric``'s hop and weight matrices equal a composition of the
  reference's ``FatTreeTopology`` (exactly);
* ``make_tofa_mesh`` on a fake 256-rank process group (in a subprocess:
  the group is process-wide) returns the ``DeviceMesh`` of its
  permutation, placed as the port's NumPy engine places on the H100
  fabric, and on the reference's v5e ``Fabric`` the port places as the
  reference's NumPy engine does: bit for bit at float64.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as R_base  # noqa: E402
from repro.configs import registry as R_reg  # noqa: E402
from repro.core.fattree import FatTreeTopology as RefFatTree  # noqa: E402
from repro.launch import roofline as R_roof  # noqa: E402
from repro.models import layers as R_layers  # noqa: E402
from repro.models import model as R_model  # noqa: E402
from repro.serve import kvcache as R_kv  # noqa: E402
from repro.train import data as R_data  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.placement import GpuFabric  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serve import kvcache  # noqa: E402
from repro_torch.train import data  # noqa: E402
from torch_ranks import run_alone  # noqa: E402

CELLS = [(a, s) for a in sorted(registry.ARCHS)
         for s in base.shape_cells(registry.get_arch(a))]
MESHES = {1: {}, 256: {"data": 16, "model": 16},
          512: {"pod": 2, "data": 16, "model": 16}}


def test_the_cells_are_the_references():
    ref = [(a, s) for a in sorted(R_reg.ARCHS)
           for s in R_base.shape_cells(R_reg.get_arch(a))]
    assert CELLS == ref and len(CELLS) > 30


def _per_dev(cfg, shape_cfg, mesh: dict) -> tuple:
    """The dry run's batch and heads per device on ``mesh``."""
    bpd = shape_cfg.global_batch
    for ax in ("pod", "data"):
        if ax in mesh and bpd % mesh[ax] == 0:
            bpd //= mesh[ax]
    hpd = cfg.n_heads or 1
    if "model" in mesh and hpd % mesh["model"] == 0:
        hpd //= mesh["model"]
    return bpd, hpd


@pytest.mark.parametrize("n", sorted(MESHES))
def test_model_flops_and_ideal_bytes_are_the_references(n):
    """Exact equality, every arch x live shape."""
    for arch, shape in CELLS:
        cfg, ref_cfg = registry.get_arch(arch), R_reg.get_arch(arch)
        sc, ref_sc = base.SHAPES[shape], R_base.SHAPES[shape]
        assert roofline.model_flops_for(cfg, sc, n) == \
            R_roof.model_flops_for(ref_cfg, ref_sc, n), (arch, shape)
        bpd, hpd = _per_dev(cfg, sc, MESHES[n])
        assert roofline.ideal_attention_bytes(cfg, sc, bpd, hpd) == \
            R_roof.ideal_attention_bytes(ref_cfg, ref_sc, bpd, hpd), \
            (arch, shape)


def test_h100_constants():
    """The H100 SXM5 80GB data sheet's, not the TPU's."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.IB_BW, roofline.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 50e9, 80e9)
    assert GpuFabric().ib_hop_cost == roofline.LINK_BW / roofline.IB_BW == 9


@pytest.mark.parametrize("terms", [
    (3.2e12, 1.1e9, 4.0e7, 1.5e12),      # compute-bound
    (1.0e9, 9.0e10, 2.0e8, 4.0e8),       # memory-bound
    (1.0e9, 1.0e8, 6.0e10, 2.0e8),       # collective-bound
    (0.0, 1.0e8, 0.0, 0.0),              # no FLOPs
])
def test_roofline_terms_are_the_references(terms):
    """Same inputs, same constants (the H100's) -> the same terms, row
    and ratios, exactly; the row lacks only ``xla_flops``."""
    flops, nbytes, coll, model_flops = terms
    kw = dict(arch="a", shape="s", mesh="16x16", n_devices=256, flops=flops,
              bytes_accessed=nbytes, collective_bytes=coll,
              model_flops=model_flops)
    consts = dict(peak_flops=roofline.PEAK_FLOPS, hbm_bw=roofline.HBM_BW,
                  link_bw=roofline.LINK_BW)
    got = roofline.Roofline(**kw)
    want = R_roof.Roofline(**kw, xla_flops=0.0, **consts)
    for prop in ("compute_s", "memory_s", "collective_s", "dominant",
                 "step_s", "useful_flops_ratio", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    want_row = want.row()
    del want_row["xla_flops"]
    assert got.row() == want_row


def _dt(x) -> str:
    """A torch or NumPy/JAX dtype's name."""
    return str(x).removeprefix("torch.") if isinstance(x, torch.dtype) \
        else np.dtype(x).name


def _flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _meta(tree) -> dict:
    flat = _flat(tree)
    assert all(t.device.type == "meta" for t in flat.values())
    return {k: (tuple(t.shape), _dt(t.dtype)) for k, t in flat.items()}


def _ref(tree) -> dict:
    return {k: (tuple(t.shape), _dt(t.dtype))
            for k, t in _flat(tree).items()}


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_abstract_stand_ins_are_the_references(arch):
    """Names, shapes and dtypes of the parameters (bf16 and f32), every
    live shape's batch and every decode shape's caches, at full width."""
    cfg, ref_cfg = registry.get_arch(arch), R_reg.get_arch(arch)
    for dt, ref_dt in ((torch.bfloat16, "bfloat16"),
                       (torch.float32, "float32")):
        got = _meta(layers.abstract_params(model.schema(cfg), dtype=dt))
        want = _ref(R_layers.abstract_params(R_model.schema(ref_cfg),
                                             dtype=ref_dt))
        assert got == want
    for shape in base.shape_cells(cfg):
        sc, ref_sc = base.SHAPES[shape], R_base.SHAPES[shape]
        assert _meta(data.input_specs(cfg, sc)) == \
            _ref(R_data.input_specs(ref_cfg, ref_sc))
        if sc.kind != "decode":
            continue
        src = cfg.n_vision_tokens if cfg.family == "vlm" else \
            (cfg.n_audio_frames or 512 if cfg.family == "encdec" else None)
        assert _meta(kvcache.abstract_cache(
            cfg, sc.global_batch, sc.seq_len, src_len=src)) == \
            _ref(R_kv.abstract_cache(ref_cfg, ref_sc.global_batch,
                                     ref_sc.seq_len, src_len=src))


def test_nemotron_stand_ins_allocate_nothing():
    """nemotron-4-340b's bf16 parameters and decode_32k caches: the bytes
    the reference's stand-ins describe, on tensors with no storage."""
    cfg, ref_cfg = registry.get_arch("nemotron-4-340b"), \
        R_reg.get_arch("nemotron-4-340b")
    sc = base.SHAPES["decode_32k"]
    trees = (layers.abstract_params(model.schema(cfg)),
             kvcache.abstract_cache(cfg, sc.global_batch, sc.seq_len))
    ref_trees = (R_layers.abstract_params(R_model.schema(ref_cfg)),
                 R_kv.abstract_cache(ref_cfg, sc.global_batch, sc.seq_len))
    leaves = [t for tree in trees for t in _flat(tree).values()]
    got = sum(t.nbytes for t in leaves)
    want = sum(int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize
               for tree in ref_trees for t in _flat(tree).values())
    assert got == want > 6e11
    assert all(t.is_meta and t.untyped_storage().data_ptr() == 0
               for t in leaves)


# ------------------------------------------------------------- H100 fabric

def _composed(n: int, k: int, p_f=None, straggler=None) -> tuple:
    """The H100 fabric's hop and weight matrices built from the
    reference's fat tree: 1 within a node, 9 x the tree's across nodes
    (its endpoint-form weights with the node's worst GPU), Eq. 1's
    penalties on each endpoint's node within a node."""
    tree = RefFatTree(k)
    host = np.arange(n) // 8

    def node(x):
        out = np.zeros(tree.n_nodes)
        for g in range(n):
            out[host[g]] = max(out[host[g]], x[g])
        return out

    same = host[:, None] == host[None, :]
    eye = np.eye(n, dtype=bool)
    hop = np.where(same, 1.0, 9.0 * tree.hop_matrix()[np.ix_(host, host)])
    hop[eye] = 0.0
    if p_f is None and straggler is None:
        return hop, hop
    hp = None if p_f is None else node(p_f)
    hs = None if straggler is None else node(straggler)
    tw = tree.weight_matrix(hp, straggler=hs)
    pen = np.zeros(n)
    if hp is not None:
        pen += 100.0 * (hp[host] > 0)
    if hs is not None:
        pen += hs[host]
    w = np.where(same, 1.0 + pen[:, None] + pen[None, :],
                 9.0 * tw[np.ix_(host, host)])
    w[eye] = 0.0
    return hop, w


@pytest.mark.parametrize("n,k", [(1, 2), (16, 2), (60, 4), (256, 6),
                                 (512, 8)])
def test_gpu_fabric_is_the_composed_fat_tree(n, k):
    fab = GpuFabric(n)
    assert fab.n_nodes == n and fab.tree().k == k
    rng = np.random.default_rng(n)
    p_f = np.where(rng.random(n) < 0.05, 0.02, 0.0)
    strag = np.where(rng.random(n) < 0.05, 1.5, 0.0)
    hop, _ = _composed(n, k)
    assert np.array_equal(fab.hop_matrix(), hop)
    assert np.array_equal(fab.weight_matrix(), hop)
    for pf, st in ((p_f, None), (None, strag), (p_f, strag)):
        assert np.array_equal(fab.weight_matrix(pf, straggler=st),
                              _composed(n, k, pf, st)[1])
    c = fab.coords_array()
    assert c.shape == (n, 4)
    assert np.array_equal(c[:, 3], np.arange(n) % 8)
    assert np.array_equal(c[:, :3],
                          RefFatTree(k).coords_array()[np.arange(n) // 8])


# ------------------------------------------------- make_tofa_mesh, fake PG

def tofa_mesh_job(out: str) -> None:
    """Run in a subprocess: a fake 256-rank group, a reduced smollm decode
    profiled on the 16x16 mesh, then ``make_tofa_mesh`` (default engine
    on the CPU, float64) and the same guest placed by the port's NumPy
    engine on the H100 fabric and, on the v5e ``Fabric``, by the port on
    the CPU and by the reference's NumPy engine."""
    from repro.core.comm_graph import CommGraph as RefComm
    from repro.core.engine import PlacementEngine as RefEngine
    from repro.core.placement import Fabric as RefFabric
    from repro.core.placement import assign_devices as ref_assign
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.core.engine import PlacementEngine
    from repro_torch.core.placement import Fabric, assign_devices
    from repro_torch.core.profiler import (comm_graph_from_profile,
                                           fake_mode, profile_torch)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_tofa_mesh)
    from repro_torch.launch.roofline import production_fabric

    torch.set_num_threads(1)
    cfg = reduced(registry.get_arch("smollm-135m"))
    sc = ShapeConfig("decode_tiny", 64, 32, "decode")
    res = {}
    with dryrun.fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with fake_mode():
            fn, args = dryrun.build_cell(cfg, sc, mesh)
        prof = profile_torch(fn, *args, mesh=mesh)
        tofa, assignment = make_tofa_mesh(prof, device="cpu",
                                          device_type="cpu")
        res["mesh"] = tofa.mesh.tolist()
        res["names"] = list(tofa.mesh_dim_names)
    perm = assignment.permutation
    res["perm"] = perm.tolist()
    comm = comm_graph_from_profile(prof)
    res["edges"] = int((comm.G_v > 0).sum())
    numpy = assign_devices(comm, production_fabric(256),
                           engine=PlacementEngine(backend="numpy"))
    res["numpy_perm"] = numpy.permutation.tolist()
    res["hop_bytes"] = [assignment.hop_bytes_linear,
                        assignment.hop_bytes_placed,
                        numpy.hop_bytes_linear, numpy.hop_bytes_placed]
    v5e = assign_devices(comm, Fabric(), device="cpu")
    ref = ref_assign(RefComm(comm.n, comm.G_v.copy(), comm.G_m.copy()),
                     RefFabric(), engine=RefEngine(backend="numpy"))
    res["v5e_perm"] = v5e.permutation.tolist()
    res["ref_v5e_perm"] = ref.permutation.tolist()
    res["v5e_hop_bytes"] = [v5e.hop_bytes_placed, ref.hop_bytes_placed]
    Path(out).write_text(json.dumps(res))


def test_make_tofa_mesh_on_a_fake_group(tmp_path):
    res = run_alone("test_torch_launch", "tofa_mesh_job", tmp_path,
                    seconds=240)
    perm = np.asarray(res["perm"])
    assert sorted(perm.tolist()) == list(range(256))
    assert res["names"] == ["data", "model"]
    assert np.array_equal(np.asarray(res["mesh"]), perm.reshape(16, 16))
    assert res["edges"] > 256
    # bit-identical to the NumPy engine on the H100 fabric (float64)
    assert res["perm"] == res["numpy_perm"]
    lin, placed, np_lin, np_placed = res["hop_bytes"]
    assert (lin, placed) == (np_lin, np_placed) and placed <= lin
    # the v5e Fabric: the port on the CPU is the reference's NumPy engine
    assert res["v5e_perm"] == res["ref_v5e_perm"]
    assert res["v5e_hop_bytes"][0] == res["v5e_hop_bytes"][1]
