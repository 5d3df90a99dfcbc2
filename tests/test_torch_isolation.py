"""Isolation of the torch port from JAX and from the reference package.

``repro_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
anything of ``repro`` (the port keeps its own copies of the NumPy modules
it needs), and the port's default engine must refuse to run when no GPU
is visible instead of quietly running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_port_loads_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.core\n"
        "import repro_torch.core.mapping_torch\n"
        "import repro_torch.kernels.hop_dist.ops\n"
        "import repro_torch.kernels.swap_gain.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.rmsnorm.ops\n"
        "import repro_torch.kernels.ssd_scan.ops\n"
        "import repro_torch.kernels.ssd_scan.ref\n"
        "import repro_torch.models.model, repro_torch.models.ssm\n"
        "import repro_torch.serve.decode, repro_torch.serve.kvcache\n"
        "import repro_torch.launch.serve, repro_torch.train.data\n"
        "import repro_torch.launch.train, repro_torch.train.checkpoint\n"
        "import repro_torch.train.optimizer, repro_torch.train.train_step\n"
        "import repro_torch.configs.registry\n"
        "import repro_torch.parallel.sharding\n"
        "import repro_torch.workloads\n"
        "import repro_torch.sim.scenarios, repro_torch.sim.batchsim\n"
        "import repro_torch.cluster.scheduler, repro_torch.beliefs\n"
        "import repro_torch.core.tofa, repro_torch.core.dragonfly\n"
        "import repro_torch.service, repro_torch.service.service\n"
        "import repro_torch.service.requests, repro_torch.service.queue\n"
        "import repro_torch.service.metrics, repro_torch.sim.replicas\n"
        "import repro_torch.core.placement, repro_torch.core.profiler\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


def test_default_engine_refuses_without_gpu(monkeypatch):
    """No CUDA device: the default engine raises, never runs on the CPU."""
    from repro_torch.core import backend
    from repro_torch.core.engine import PlacementEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    with pytest.raises(backend.BackendUnavailableError):
        PlacementEngine()
    with pytest.raises(backend.BackendUnavailableError):
        PlacementEngine(backend="torch")
    with pytest.raises(backend.BackendUnavailableError):
        backend.get_backend("torch")
    with pytest.raises(backend.BackendUnavailableError):
        with backend.use("torch"):
            pass
    assert PlacementEngine(device="cpu").backend.device.type == "cpu"


def test_direct_mapping_call_targets_the_card(monkeypatch):
    """A device kernel called outside any backend scope resolves the
    default torch backend, i.e. the card — and raises without one."""
    import numpy as np
    from repro_torch.core import backend, mapping_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    with pytest.raises(backend.BackendUnavailableError):
        mapping_torch.select_nodes(np.ones((4, 4)), 2)


@pytest.mark.parametrize("entry", ["refine_batch", "hop_bytes_batch",
                                   "select_nodes", "greedy_placement",
                                   "multilevel_map", "tofa_policy"])
def test_dispatching_entry_points_target_the_card(monkeypatch, entry):
    """The dispatching mapping module, multilevel and the policies, called
    outside any backend scope, run on the default torch backend on the
    card — so without a GPU they raise instead of running on the host."""
    import numpy as np
    from repro_torch import interop
    from repro_torch.core import backend, mapping, multilevel
    from repro_torch.core.policies import PolicyContext, get_policy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    topo = interop.topology(torus_dims=(4, 4, 4))
    D, coords = topo.hop_matrix(), topo.coords_array()
    G = np.zeros((8, 8))
    G[np.arange(7), np.arange(1, 8)] = G[np.arange(1, 8), np.arange(7)] = 1.0
    P = np.stack([np.arange(8), np.arange(8, 16)])
    calls = {
        "refine_batch": lambda: mapping.refine_batch(G, D, P),
        "hop_bytes_batch": lambda: mapping.hop_bytes_batch(G, D, P),
        "select_nodes": lambda: mapping.select_nodes(D, 8),
        "greedy_placement": lambda: mapping.greedy_placement(
            G, np.arange(64), D),
        "multilevel_map": lambda: multilevel.multilevel_map(
            G, np.arange(64), coords, D=D),
        "tofa_policy": lambda: get_policy("tofa").place(PolicyContext(
            request=None, G_w=G, coords=coords, hops=D, p_f=np.zeros(64),
            available=np.arange(64), rng=np.random.default_rng(0))),
    }
    with pytest.raises(backend.BackendUnavailableError):
        calls[entry]()


@pytest.mark.parametrize("entry", ["forward", "encode",
                                   "prefill_cross_cache"])
def test_source_inputs_follow_the_model(entry):
    """``Transformer.forward``'s ``vision_embed`` / ``enc_embed``, ``encode``
    and ``prefill_cross_cache`` take source embeddings from anywhere and
    run where the model lives (``cuda`` unless the caller asked for the
    CPU): a ``meta`` tensor handed to a CPU model is moved to the CPU,
    where it has no data to copy, and raises there."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model
    from repro_torch.serve.decode import encode, prefill_cross_cache

    vlm = model.init(reduced(get_arch("llama-3.2-vision-11b")),
                     device="cpu")
    enc = model.init(reduced(get_arch("seamless-m4t-large-v2")),
                     device="cpu")
    meta = torch.empty((1, 8, 64), device="meta")
    calls = {
        "forward": lambda: vlm(torch.zeros((1, 4), dtype=torch.int64),
                               vision_embed=meta),
        "encode": lambda: encode(enc, meta),
        "prefill_cross_cache": lambda: prefill_cross_cache(vlm, meta),
    }
    with pytest.raises(NotImplementedError, match="meta"):
        calls[entry]()


def test_interop_round_trip():
    import numpy as np
    from repro_torch import interop
    from repro_torch.core.state import NodeHealth

    G = np.array([[0.0, 2.0], [2.0, 0.0]])
    req = interop.request(G, torus_dims=(2, 2), p_f=np.array([0, .1, 0, 0]))
    assert req.comm.n == 2 and req.n_nodes == 4
    assert req.comm.G_v is not G and np.array_equal(req.comm.G_v, G)
    assert req.p_f[1] == 0.1
    with pytest.raises(ValueError):
        interop.topology(torus_dims=(2, 2), fattree_k=4)
    health = np.array([0, int(NodeHealth.DOWN), 0, 0], dtype=np.int8)
    s = interop.cluster_state(health, np.zeros(4))
    assert s.available_ids().tolist() == [0, 2, 3]
    req2 = interop.request(G, torus_dims=(4,), state=s)
    assert req2.available_ids.tolist() == [0, 2, 3]
    assert req2.p_f.tolist() == [0.0, 1.0, 0.0, 0.0]
    assert interop.topology(fattree_k=4).n_nodes == 16


@pytest.mark.parametrize("entry", [
    "Transformer", "init", "init_cache", "serve_main", "extra_inputs",
    "Transformer-mamba2", "init_cache-mamba2", "Transformer-vlm",
    "Transformer-encdec", "init_cache-vlm", "init_cache-encdec",
    "serve_main-vlm", "serve_main-encdec", "train_main"])
def test_model_entry_points_target_the_card(monkeypatch, entry):
    """The model, its caches and the serve driver are made on ``cuda``
    unless the caller asks for the CPU: without a GPU they raise, and
    nothing is allocated on the host to be moved later."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import backend
    from repro_torch.launch import serve, train
    from repro_torch.models import model
    from repro_torch.serve.kvcache import init_cache
    from repro_torch.train.data import extra_inputs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("smollm-135m"))
    ssm_cfg = reduced(get_arch("mamba2-2.7b"))
    vlm = "llama-3.2-vision-11b"
    vlm_cfg = reduced(get_arch(vlm))
    enc_cfg = reduced(get_arch("seamless-m4t-large-v2"))
    calls = {
        "Transformer": lambda: model.Transformer(cfg),
        "init": lambda: model.init(cfg, seed=0),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "serve_main": lambda: serve.main(["--reduced", "--gen", "1",
                                          "--prompt-len", "2"]),
        "extra_inputs": lambda: extra_inputs(
            reduced(get_arch("llama-3.2-vision-11b")), 1),
        "Transformer-mamba2": lambda: model.Transformer(ssm_cfg),
        "init_cache-mamba2": lambda: init_cache(ssm_cfg, 1, 8),
        "Transformer-vlm": lambda: model.Transformer(vlm_cfg),
        "Transformer-encdec": lambda: model.Transformer(enc_cfg),
        "init_cache-vlm": lambda: init_cache(vlm_cfg, 1, 8),
        "init_cache-encdec": lambda: init_cache(enc_cfg, 1, 8, src_len=16),
        "serve_main-vlm": lambda: serve.main([
            "--arch", vlm, "--reduced", "--gen", "1", "--prompt-len", "2"]),
        "serve_main-encdec": lambda: serve.main([
            "--arch", "seamless-m4t-large-v2", "--reduced", "--gen", "1",
            "--prompt-len", "2"]),
        "train_main": lambda: train.main(["--reduced", "--steps", "1"]),
    }
    with pytest.raises(backend.BackendUnavailableError):
        calls[entry]()
