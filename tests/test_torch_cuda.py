"""The port's CUDA kernels and placement path on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels
are compiled with ``nvcc`` at first use and have no CPU mode): they carry
the ``cuda`` marker and skip elsewhere.  On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The module imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch.  Each kernel is held exactly equal to
its plain PyTorch version (integer-valued inputs), and each refine branch
of a placement on the card must return the placement the plain versions
return on the CPU, having launched the kernel of its branch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import (PlacementEngine,  # noqa: E402
                                     PlacementRequest)
from repro_torch.core.fattree import FatTreeTopology  # noqa: E402
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.hop_dist import ops as hop_ops  # noqa: E402
from repro_torch.kernels.hop_dist.ref import (  # noqa: E402
    fattree_hop_pairs_ref, torus_hop_pairs_ref)
from repro_torch.kernels.swap_gain.ops import swap_select  # noqa: E402
from repro_torch.kernels.swap_gain.ref import swap_select_ref  # noqa: E402
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
