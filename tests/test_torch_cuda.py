"""The port's CUDA kernels and placement path on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels
are compiled with ``nvcc`` at first use and have no CPU mode): they carry
the ``cuda`` marker and skip elsewhere.  On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The module imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch.  The placement kernels are held exactly
equal to their plain PyTorch versions (integer-valued inputs), and each
refine branch of a placement on the card must return the placement the
plain versions return on the CPU, having launched the kernel of its
branch.  The attention and normalisation kernels are held to their plain
versions within the reference's kernel-test tolerances (2e-5 in float32,
2e-2 in bfloat16), the SSD scan kernel within that test's 5e-5 / 5e-2 to
the exact recurrence and to the chunked algorithm, and the models'
forwards through the kernels to their forwards through the plain
versions within 1e-4.  Two scenario presets, the placement service's
fast storm and four fat-tree replicas with their placements on the card
must return what they return with their placements on the CPU, and every
spelling of the card must give one shared default engine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.engine import (PlacementEngine,  # noqa: E402
                                     PlacementRequest)
from repro_torch.core.fattree import FatTreeTopology  # noqa: E402
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.hop_dist import ops as hop_ops  # noqa: E402
from repro_torch.kernels.hop_dist.ref import (  # noqa: E402
    fattree_hop_pairs_ref, torus_hop_pairs_ref)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (ssd_scan,  # noqa: E402
                                              ssd_scan_kernel,
                                              ssd_scan_stages)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunk_parallel, ssd_scan_ref)
from repro_torch.kernels.swap_gain.ops import (swap_gain,  # noqa: E402
                                               swap_select)
from repro_torch.kernels.swap_gain.ref import (swap_gain_ref,  # noqa: E402
                                               swap_select_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.workloads.patterns import (alltoall_heavy,  # noqa: E402
                                            npb_dt_like)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """A CUDA device, decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _select_inputs(n, B, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 7, (B, n, n))
    M = A + A.transpose(0, 2, 1)
    S = rng.integers(0, 5, (n, n)) * (rng.random((n, n)) < 0.3)
    G = S + S.T
    return M, G, (G[None] * M).sum(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hop_kernels_equal_plain_versions(cuda_device, dtype):
    rng = np.random.default_rng(1)
    for dims in [(8, 8, 8), (5, 7), (2, 3, 4, 3), (9,)]:
        cu, cv = (torch.tensor(np.stack([rng.integers(0, d, (3, m))
                                         for d in dims], -1),
                               dtype=dtype, device=cuda_device)
                  for m in (37, 300))
        assert torch.equal(hop_ops.torus_hop(cu, cv, dims, impl="kernel"),
                           torus_hop_pairs_ref(cu, cv, dims))
    f, g = (torch.tensor(rng.integers(0, 3, (3, m, 3)), dtype=dtype,
                         device=cuda_device) for m in (37, 300))
    assert torch.equal(hop_ops.fattree_hop(f, g, impl="kernel"),
                       fattree_hop_pairs_ref(f, g))
    # the unbatched form
    assert torch.equal(hop_ops.fattree_hop(f[0], g[0], impl="kernel"),
                       fattree_hop_pairs_ref(f[0], g[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_valid", [(16, 16), (200, 180), (300, 256)])
def test_swap_select_equals_plain_version(cuda_device, dtype, n, n_valid):
    M, G, contrib = (torch.tensor(a, dtype=dtype, device=cuda_device)
                     for a in _select_inputs(n, B=4))
    # a padding mover (>= n_valid) among live ones
    i = torch.tensor([0, n // 3, n_valid - 1, n - 1], device=cuda_device)
    got = swap_select(M, G, contrib, i, n_valid, impl="kernel")
    want = swap_select_ref(M, G, contrib, i, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_swap_select_rejects_when_no_gain(cuda_device):
    n, B = 64, 3
    one = torch.ones((n, n), dtype=torch.float64, device=cuda_device) \
        - torch.eye(n, dtype=torch.float64, device=cuda_device)
    M = one.expand(B, n, n).contiguous()
    i = torch.tensor([0, 5, 63], device=cuda_device)
    gain, j = swap_select(M, one, (one[None] * M).sum(-1), i, n,
                          impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(j, i)
    assert bool((gain <= 1e-9).all())


def _faults(n_nodes, count=6):
    p_f = np.zeros(n_nodes)
    p_f[np.random.default_rng(5).choice(n_nodes, count, replace=False)] = 0.1
    return p_f


@pytest.mark.parametrize("cell,need", [
    ("torus-dense-D", None),
    ("alltoall-guest", "swap_select"),
    ("implicit-torus", "torus_hop"),
    ("implicit-fattree-faulty", "fattree_hop"),
])
def test_placement_on_card_equals_cpu(cuda_device, cell, need):
    lazy = 0 if cell.startswith("implicit") else None
    if cell == "torus-dense-D":
        req = PlacementRequest(comm=npb_dt_like(40).comm,
                               topology=TorusTopology((4, 4, 4)))
    elif cell == "alltoall-guest":
        req = PlacementRequest(comm=alltoall_heavy(40).comm,
                               topology=TorusTopology((4, 4, 4)))
    elif cell == "implicit-torus":
        req = PlacementRequest(comm=npb_dt_like(40).comm,
                               topology=TorusTopology((4, 4, 4)))
    else:
        ft = FatTreeTopology(8)
        req = PlacementRequest(comm=npb_dt_like(40).comm, topology=ft,
                               p_f=_faults(ft.n_nodes))
    cpu = PlacementEngine(device="cpu", lazy_threshold=lazy).place(
        req, policy="tofa", rng=np.random.default_rng(0))
    reset_launches()
    card = PlacementEngine(lazy_threshold=lazy).place(
        req, policy="tofa", rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    assert np.array_equal(card.placement, cpu.placement)
    assert card.hop_bytes == cpu.hop_bytes
    if need is not None:
        assert LAUNCHES[need] > 0


# ------------------------------------------------ model-stack kernels
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_SHAPES = [
    (1, 2, 2, 64, 64, 32, True),
    (1, 4, 2, 2048, 2048, 16, True),  # the reduced configs' head dim
    (2, 4, 2, 96, 96, 64, True),      # GQA, padding
    (1, 4, 1, 32, 128, 64, True),     # Sq < Sk: the end-aligned diagonal
    (2, 2, 2, 64, 64, 128, False),    # non-causal
    (1, 8, 4, 200, 200, 64, True),    # ragged tail
    (1, 9, 3, 128, 128, 64, True),    # smollm's 9 heads over 3 KV heads
    (1, 9, 3, 2050, 2050, 64, True),  # ragged past the model's S = 2048
    (1, 2, 1, 70, 300, 96, True),     # Sq < Sk across several key tiles
    (1, 4, 2, 130, 130, 128, False),
    (1, 2, 2, 100, 100, 192, True),   # MLA prefill head dims
    (1, 2, 1, 65, 190, 256, True),
    (2, 9, 3, 2048, 2048, 64, True),  # smollm-135m's prefill, the main shape
    (1, 2, 2, 100, 130, 192, False),  # non-causal at the MLA head dim
    (1, 4, 2, 40, 300, 192, True),    # Sq < Sk at the MLA head dim
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh,causal", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, B, H, Hkv, Sq, Sk, Dh,
                                    causal, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device
                           ).to(dtype)
               for shape in ((B, H, Sq, Dh), (B, Hkv, Sk, Dh),
                             (B, Hkv, Sk, Dh)))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, impl="kernel")
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_kernel_refuses_grad(cuda_device):
    q = torch.randn(1, 2, 8, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, impl="kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 128), (4096, 576),
                                   (5, 1000)])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(shape[-1], generator=g, device=cuda_device)
         + 1.0).to(dtype)
    got = rmsnorm(x, w, impl="kernel")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, w).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [16, 200, 1024])
def test_swap_gain_kernel_equals_plain(cuda_device, dtype, n):
    M, G, contrib = (torch.tensor(a, dtype=dtype, device=cuda_device)
                     for a in _select_inputs(n, B=1))
    for i in (0, n // 3, n - 1):
        iv = torch.tensor([i], device=cuda_device)
        got = swap_gain(M[0], G, contrib[0], iv, impl="kernel")
        want = swap_gain_ref(M, G, contrib, iv)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("S", [64, 2048])
def test_forward_kernel_matches_plain(cuda_device, S):
    """The reduced model through the flash kernel (S = 2048) against the
    same model through the plain version; S = 64 runs neither."""
    cfg = reduced(get_arch("smollm-135m"))
    model = M.init(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, S), device=cuda_device)
    reset_launches()
    with torch.inference_mode():
        got = model(toks, impl="kernel")
        launched = LAUNCHES["flash_attention"]
        want = model(toks, impl="ref")
    assert launched == (cfg.n_layers if S >= 2048 else 0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_serve_main_on_card(cuda_device, capsys):
    assert serve.main(["--reduced", "--batch", "2", "--prompt-len", "8",
                       "--gen", "4"]) == 0
    assert capsys.readouterr().out.count("\n") == 3


# ------------------------------------------------------------- ssd_scan
SSD_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
SSD_SHAPES = [                        # (B, H, G, S, P, N, chunk)
    (1, 2, 1, 64, 16, 16, 16),        # the reference's kernel tests
    (2, 4, 2, 128, 32, 32, 32),
    (1, 8, 1, 96, 64, 128, 32),
    (2, 8, 1, 64, 16, 16, 8),         # reduced mamba2
    (2, 80, 1, 2048, 64, 128, 64),    # mamba2-2.7b, B 2 x 2048
    (2, 80, 1, 2048, 64, 128, 128),   # the entry point's default chunk
    (1, 4, 1, 64, 20, 24, 64),        # one chunk; P, N not multiples of 16
    (2, 6, 3, 96, 16, 40, 96),        # chunk = S > 64: a ragged second tile
    (1, 2, 1, 200, 8, 8, 100),        # chunk 100: tiles of 64, ragged last
    (1, 4, 2, 48, 33, 17, 16),        # P, N odd: the element-wise paths
]


def _ssd_inputs(device, B, H, G, S, P, N, dtype, seed=1):
    """The reference's kernel-test distribution: xdt, B, C normal * 0.5,
    dA = -softplus(normal) * 0.5."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device=device)
    xdt = (rand(B, H, S, P) * 0.5).to(dtype)
    dA = (-torch.nn.functional.softplus(rand(B, H, S)) * 0.5).to(dtype)
    Bm = (rand(B, G, S, N) * 0.5).to(dtype)
    Cm = (rand(B, G, S, N) * 0.5).to(dtype)
    return xdt, dA, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,P,N,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda_device, B, H, G, S, P, N, chunk,
                                  dtype):
    """The kernel against the exact recurrence in both types, and against
    the chunked algorithm (its ``impl="ref"``) in float32."""
    xdt, dA, Bm, Cm = _ssd_inputs(cuda_device, B, H, G, S, P, N, dtype)
    reset_launches()
    y, st = ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk, impl="kernel")
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = SSD_TOL[dtype]
    want = [ssd_scan_ref(xdt, dA, Bm, Cm, chunk)]
    if dtype == torch.float32:
        want.append(ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk, impl="ref"))
    for y_r, st_r in want:
        torch.testing.assert_close(y.float(), y_r.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(st, st_r, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,P,N,chunk", SSD_SHAPES)
def test_ssd_kernel_stages_match_staged_plain(cuda_device, B, H, G, S, P, N,
                                              chunk, dtype):
    """Each stage of the kernel (the tiles' own states and decays, the
    states entering each tile, the final state) against the staged plain
    version on the same tiles of min(chunk, 64) rows."""
    xdt, dA, Bm, Cm = _ssd_inputs(cuda_device, B, H, G, S, P, N, dtype)
    reset_launches()
    got = ssd_scan_stages(xdt, dA, Bm, Cm, chunk=chunk)
    _, st_r, want = ssd_chunk_parallel(xdt, dA, Bm, Cm, min(chunk, S, 64))
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 0
    tol = SSD_TOL[dtype]
    for name in ("decays", "chunk_states", "passed_states"):
        assert got[name].shape == want[name].shape, name
        torch.testing.assert_close(got[name], want[name], atol=tol, rtol=tol,
                                   msg=name)
    torch.testing.assert_close(got["final_state"], st_r, atol=tol, rtol=tol)


def test_ssd_entry_point_model_layout(cuda_device):
    """The model-layout entry point folds dt in and launches the kernel;
    it agrees with the chunked algorithm on the same inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, S, H, P, G, N = 2, 96, 4, 16, 2, 32
    x = torch.randn((B, S, H, P), generator=g, device=cuda_device) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=cuda_device))
    A = -torch.exp(torch.randn(H, generator=g, device=cuda_device) * 0.3)
    Bm, Cm = (torch.randn((B, S, G, N), generator=g, device=cuda_device)
              * 0.5 for _ in range(2))
    reset_launches()
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    assert LAUNCHES["ssd_scan"] == 1
    y_r, st_r = ssd_scan(x, dt, A, Bm, Cm, chunk=32, impl="ref")
    torch.testing.assert_close(y, y_r, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(st, st_r, atol=5e-5, rtol=5e-5)


def test_ssd_kernel_refuses_grad(cuda_device):
    xdt, dA, Bm, Cm = _ssd_inputs(cuda_device, 1, 2, 1, 16, 16, 16,
                                  torch.float32)
    xdt.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=8, impl="kernel")


def test_ssd_kernel_refuses_chunk_not_dividing_seq(cuda_device):
    xdt, dA, Bm, Cm = _ssd_inputs(cuda_device, 1, 2, 1, 24, 16, 16,
                                  torch.float32)
    with pytest.raises(ValueError):
        ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=16, impl="kernel")


@pytest.mark.parametrize("S", [8, 64])
def test_mamba2_forward_kernel_matches_plain(cuda_device, S):
    """Reduced mamba2 through the ssd_scan kernel (once per layer) against
    the same model through the plain version."""
    cfg = reduced(get_arch("mamba2-2.7b"))
    model = M.init(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, S), device=cuda_device)
    reset_launches()
    with torch.inference_mode():
        got = model(toks, impl="kernel")
        launched = LAUNCHES["ssd_scan"]
        want = model(toks, impl="ref")
    assert launched == cfg.n_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_serve_main_on_card(cuda_device, capsys, dtype):
    assert serve.main(["--arch", "mamba2-2.7b", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4",
                       "--dtype", dtype]) == 0
    assert capsys.readouterr().out.count("\n") == 3


def _without_wall_clock(x):
    if isinstance(x, dict):
        return {k: _without_wall_clock(v) for k, v in x.items()
                if k != "place_time_s"}
    if isinstance(x, (list, tuple)):
        return [_without_wall_clock(v) for v in x]
    return x


@pytest.mark.parametrize("name", ["paper-fig4-5", "saturated-queue"])
def test_fast_preset_on_card_equals_cpu(cuda_device, name):
    """A scenario preset whose placements run on the card returns what
    the same preset returns with its placements on the CPU, wall-clock
    fields excepted."""
    from repro_torch.sim.scenarios import run_preset

    got = run_preset(name, fast=True, device="cuda")
    want = run_preset(name, fast=True, device="cpu")
    assert _without_wall_clock(got) == _without_wall_clock(want)


@pytest.mark.parametrize("spelling", [None, "cuda", "cuda:0",
                                      torch.device("cuda"),
                                      torch.device("cuda", 0)])
def test_default_engine_one_per_card(cuda_device, spelling):
    """``None``, ``"cuda"``, ``"cuda:0"`` and the ``torch.device`` forms
    name one card: one shared engine, on that card."""
    from repro_torch.core.engine import default_engine

    eng = default_engine(spelling)
    assert eng is default_engine(None) is default_engine("cuda:0")
    assert eng.backend.device.type == "cuda"


def test_fast_storm_on_card_equals_cpu(cuda_device):
    """The storm of the placement service at its fast size with the
    engine on the card returns every simulated field and the placement
    log it returns with the engine on the CPU."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    got = chip_smoke.run_storm(chip_smoke.STORM_FAST, device="cuda")
    want = chip_smoke.run_storm(chip_smoke.STORM_FAST, device="cpu")
    for policy, res in got.items():
        assert chip_smoke.simulated(res.row) == \
            chip_smoke.simulated(want[policy].row), policy
        assert [n for _, n in res.placement_log] == \
            [n for _, n in want[policy].placement_log]


def test_replicas_on_card_equal_cpu(cuda_device):
    """Four fat-tree replicas with their engines on the card (the serial
    executor ``auto`` picks there) equal the same replicas on the CPU."""
    from repro_torch.sim.replicas import run_replicas

    got = run_replicas("fat-tree", n_replicas=4, fast=True, device="cuda")
    want = run_replicas("fat-tree", n_replicas=4, fast=True, device="cpu",
                        executor="serial")
    for pol, metrics in want.metrics.items():
        for k, v in metrics.items():
            if k != "place_time_s":
                assert np.array_equal(got.metrics[pol][k], v), (pol, k)
