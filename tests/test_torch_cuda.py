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
2e-2 in bfloat16; the float32 flash kernel, 3xTF32 on the tensor cores,
is also held to the plain version run in float64, at most twice as far
from it as the float32 plain version), the SSD scan kernel within that test's 5e-5 / 5e-2 to
the exact recurrence and to the chunked algorithm.  The backward kernels
(through the wrappers' ``autograd.Function`` classes) are held to autograd of
the plain versions within the same tolerances as shares of each
gradient's largest magnitude, to the plain versions' float64 gradients
at most twice as far as the same-dtype plain versions' (float32; the SSD
backward in bfloat16 too), bit for
bit from one run to the next; a reduced model's gradients through them
to its gradients through the plain versions within 1e-4.  The models'
forwards through the kernels to their forwards through the plain
versions within 1e-4 (zamba2-7b and minicpm3-4b at full width with their
depth cut, through the flash kernel at head dims 112 and 96 and the SSD
kernel at d_state 64; reduced deepseek-v2-lite-16b and phi3.5-moe-42b
with their own head dims, 192 and 128; reduced llama-3.2-vision-11b and
seamless-m4t-large-v2 with theirs, 128 and 64, their cross-attention to
seeded source embeddings on the plain path, and their decode steps, on
the frozen cross cache, to the same forward).  The MoE FFN on the card
must route as on the CPU and agree with it within 1e-5.  Two scenario presets, the placement service's
fast storm and four fat-tree replicas with their placements on the card
must return what they return with their placements on the CPU, and every
spelling of the card must give one shared default engine.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.engine import (PlacementEngine,  # noqa: E402
                                     PlacementRequest)
from repro_torch.core.fattree import FatTreeTopology  # noqa: E402
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.kernels import (LAUNCHES, SHAPES,  # noqa: E402
                                 reset_launches)
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
    ssd_chunk_parallel, ssd_chunked_folded, ssd_scan_ref)
from repro_torch.kernels.swap_gain.ops import (swap_gain,  # noqa: E402
                                               swap_select)
from repro_torch.kernels.swap_gain.ref import (GAIN_EPS,  # noqa: E402
                                               swap_gain_ref,
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


def _chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, loaded as a module:
    its storm runner and its MoE routing rule."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


# (B, m, k) at the edges of hop_dist.cu's map: k of 1-3 and odd, k not a
# multiple of 4 or of 2, m under a tile's rows and a tile of many rows of
# one column (TX 1, TY 128), ragged column tiles, the chunk refines'
# (1, n, n) and the path's and TOFA's stacks
HOP_EDGE_SHAPES = [(1, 1, 1), (2, 3, 1), (1, 5, 2), (3, 7, 3), (2, 1, 37),
                   (1, 9, 6), (2, 30, 10), (1, 2, 256), (4, 3, 130),
                   (3, 700, 1), (2, 300, 200),
                   (1, 4, 4), (1, 17, 17), (1, 33, 33), (1, 64, 64),
                   (2, 512, 512), (16, 1024, 1024)]


def _hop_coords(rng, ext, B, n, dtype, device, offset=0):
    """(B, n, len(ext)) integer coordinates below ``ext``; with ``offset``
    a contiguous slice that starts ``offset`` batches into its storage."""
    full = np.stack([rng.integers(0, e, (B + offset, n)) for e in ext], -1)
    return torch.tensor(full, dtype=dtype, device=device)[offset:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,m,k", HOP_EDGE_SHAPES)
def test_hop_kernels_equal_plain_versions_at_edges(cuda_device, dtype, B, m,
                                                   k):
    rng = np.random.default_rng(B * 7919 + m * 31 + k)
    for dims in [(32, 32, 16), (5, 7), (2, 3, 4, 3), (9,)]:
        cu = _hop_coords(rng, dims, B, m, dtype, cuda_device, offset=1)
        cv = _hop_coords(rng, dims, B, k, dtype, cuda_device)
        assert cu.storage_offset() > 0 and cu.is_contiguous()
        assert torch.equal(hop_ops.torus_hop(cu, cv, dims, impl="kernel"),
                           torus_hop_pairs_ref(cu, cv, dims))
    cu = _hop_coords(rng, (32, 16, 16), B, m, dtype, cuda_device, offset=1)
    cv = _hop_coords(rng, (32, 16, 16), B, k, dtype, cuda_device)
    assert torch.equal(hop_ops.fattree_hop(cu, cv, impl="kernel"),
                       fattree_hop_pairs_ref(cu, cv))
    # coordinates of few distinct values, so that every level matches; the
    # column table a slice too
    f = _hop_coords(rng, (2, 2, 2), B, m, dtype, cuda_device)
    g = _hop_coords(rng, (2, 2, 2), B, k, dtype, cuda_device, offset=1)
    assert torch.equal(hop_ops.fattree_hop(f, g, impl="kernel"),
                       fattree_hop_pairs_ref(f, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,m,k", [(2, 30, 64), (1, 9, 8), (2, 512, 512)])
def test_hop_kernels_write_an_unaligned_output_exactly(cuda_device, dtype,
                                                       B, m, k):
    """An output that starts one element past 16-byte alignment is written
    exactly, and nothing before or after it."""
    rng = np.random.default_rng(5)
    dims = (32, 32, 16)
    cu = _hop_coords(rng, dims, B, m, dtype, cuda_device)
    cv = _hop_coords(rng, dims, B, k, dtype, cuda_device)
    for kind, extra, want in [
            ("torus", hop_ops._torus_args(dims),
             torus_hop_pairs_ref(cu, cv, dims)),
            ("fattree", (), fattree_hop_pairs_ref(cu, cv))]:
        buf = torch.full((B * m * k + 2,), -7.0, dtype=dtype,
                         device=cuda_device)
        err = hop_ops._fn(kind, dtype)(
            cu.data_ptr(), cv.data_ptr(), buf[1:].data_ptr(), B, m, k,
            *extra, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(buf[1:-1].view(B, m, k), want)
        assert buf[0].item() == -7.0 and buf[-1].item() == -7.0


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


# zamba2-7b's head dim 112 and minicpm3-4b's MLA prefill (q/k of 64 + 32,
# V padded from 64 to 96), each at its model's B 2 x 2048
NEW_HEAD_DIM_SHAPES = [
    (1, 4, 4, 300, 300, 112, True),      # ragged tail
    (1, 2, 1, 70, 300, 112, True),       # Sq < Sk, GQA
    (1, 4, 4, 130, 130, 112, False),     # non-causal
    (2, 32, 32, 2048, 2048, 112, True),  # zamba2-7b's shared block
    (2, 40, 40, 2048, 2048, 96, True),   # minicpm3-4b's MLA prefill
    (2, 16, 16, 2048, 2048, 64, True),   # seamless-m4t's decoder self-attn
    (2, 36, 4, 2048, 2048, 128, True),   # starcoder2-7b: 9 heads a KV head
    (2, 96, 8, 2048, 2048, 192, True),   # nemotron-4-340b: 12 a KV head
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh,causal", NEW_HEAD_DIM_SHAPES)
def test_flash_kernel_model_head_dims_match_plain(cuda_device, B, H, Hkv,
                                                  Sq, Sk, Dh, causal, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(4)
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


# reduced copies of the model shapes the float32 kernel runs: smollm-135m's
# Dh 64 (9 heads over 3), minicpm3-4b's 96 and zamba2-7b's 112, B 1 x 512;
# phi3.5-moe-42b's 128 (4 heads a KV head) and deepseek-v2-lite-16b's 192
# (MLA with V padded), B 1 x 256
F64_SHAPES = [
    (1, 9, 3, 512, 512, 64),
    (1, 8, 8, 512, 512, 96),
    (1, 8, 8, 512, 512, 112),
    (1, 8, 2, 256, 256, 128),
    (1, 4, 4, 256, 256, 192),
    (1, 16, 16, 512, 512, 64),   # seamless-m4t's 16 heads of 64
    (2, 36, 4, 2048, 2048, 128),  # starcoder2-7b's GQA at its B 2 x 2048
    (2, 96, 8, 2048, 2048, 192),  # nemotron-4-340b's
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh", F64_SHAPES)
def test_flash_kernel_f32_as_accurate_as_plain_f32(cuda_device, B, H, Hkv,
                                                   Sq, Sk, Dh):
    """The float32 kernel (3xTF32 on the tensor cores), held to the plain
    version run in float64, is at most twice as far from it as the float32
    plain version, and returns the same output whatever ``allow_tf32``
    says."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device)
               for shape in ((B, H, Sq, Dh), (B, Hkv, Sk, Dh),
                             (B, Hkv, Sk, Dh)))
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        got = flash_attention(q, k, v, causal=True, impl="kernel")
        plain = flash_attention_ref(q, k, v, causal=True)
        torch.backends.cuda.matmul.allow_tf32 = True
        again = flash_attention(q, k, v, causal=True, impl="kernel")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                causal=True)
    torch.cuda.synchronize()
    assert exact.dtype == torch.float64
    assert torch.equal(got, again)
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= 2 * plain_err, (err, plain_err)


def test_flash_kernel_refuses_unbuilt_head_dim(cuda_device):
    """The reduced MLA config's q/k of 16 + 8 columns: no instance, no
    fallback to the plain version."""
    q = torch.randn(1, 2, 8, 24, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q, impl="kernel")


# the backward kernels: every head dim, GQA ratios, Sq < Sk, non-causal
FLASH_BWD_SHAPES = [
    (1, 2, 2, 64, 64, 32, True),
    (1, 4, 2, 2048, 2048, 16, True),  # the reduced configs' head dim
    (2, 4, 2, 96, 96, 64, True),      # GQA, padding
    (1, 4, 1, 32, 128, 64, True),     # Sq < Sk
    (2, 2, 2, 64, 64, 128, False),    # non-causal
    (1, 9, 3, 130, 130, 64, True),    # smollm's 9 heads over 3
    (1, 2, 1, 70, 300, 96, True),     # Sq < Sk across several key tiles
    (1, 4, 2, 130, 130, 112, True),   # zamba2's head dim
    (1, 8, 2, 100, 100, 128, True),   # phi3.5's 4 heads a KV head
    (1, 2, 2, 100, 130, 192, False),  # the MLA head dim, non-causal
    (1, 4, 2, 40, 300, 192, True),
    (1, 2, 1, 65, 190, 256, True),
    # straddling the tiles (64 query rows in dQ; 64 or 32 keys and 16 to
    # 64 queries in dK/dV): Sq and Sk of 129 and 257
    (1, 4, 2, 129, 129, 64, True),
    (1, 2, 1, 257, 257, 96, True),
    (1, 4, 4, 129, 257, 128, True),
    (1, 2, 2, 257, 129, 128, False),
    (1, 2, 1, 129, 257, 256, True),
    # nemotron-4-340b's GQA ratio of 12 (96 heads over 8), reduced in length
    (1, 12, 1, 257, 257, 192, True),
    (1, 24, 2, 129, 129, 64, True),
]


def _flash_grads(q, k, v, dout, fn):
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def _rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh,causal", FLASH_BWD_SHAPES)
def test_flash_backward_matches_plain(cuda_device, B, H, Hkv, Sq, Sk, Dh,
                                      causal, dtype):
    """dq, dk and dv through _FlashAttention (two backward launches)
    against autograd of the plain version, as shares of each gradient's
    largest magnitude within the forward's tolerances."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn(B, H, Sq, Dh, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B, Hkv, Sk, Dh, generator=g,
                        device=cuda_device).to(dtype) for _ in range(2))
    dout = torch.randn(B, H, Sq, Dh, generator=g, device=cuda_device)
    reset_launches()
    got = _flash_grads(q, k, v, dout, lambda *t: flash_attention(
        *t, causal=causal, impl="kernel"))
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert LAUNCHES["flash_attention_bwd"] == 1
    want = _flash_grads(q, k, v, dout, lambda *t: flash_attention_ref(
        *t, causal=causal))
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _rel_err(a, b) <= TOL[dtype]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh", [(2, 9, 3, 2048, 2048, 64),
                                             (1, 8, 2, 1024, 1024, 128),
                                             (1, 4, 4, 1024, 1024, 112)])
def test_flash_backward_f32_as_accurate_as_plain_f32(cuda_device, B, H, Hkv,
                                                     Sq, Sk, Dh):
    """Against the plain version's gradients in float64, each of the
    kernel's float32 gradients at most twice as far as the float32 plain
    version's (chip_smoke's rule for kernel/flash_attention_bwd)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = torch.randn(B, H, Sq, Dh, generator=g, device=cuda_device)
    k, v = (torch.randn(B, Hkv, Sk, Dh, generator=g, device=cuda_device)
            for _ in range(2))
    dout = torch.randn(B, H, Sq, Dh, generator=g, device=cuda_device)
    got = _flash_grads(q, k, v, dout, lambda *t: flash_attention(
        *t, impl="kernel"))
    plain = _flash_grads(q, k, v, dout, flash_attention_ref)
    exact = _flash_grads(q.double(), k.double(), v.double(), dout,
                         flash_attention_ref)
    for a, p, e in zip(got, plain, exact):
        assert _rel_err(a, e) <= 2 * _rel_err(p, e)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh", [(2, 9, 3, 2048, 2048, 64),
                                             (1, 8, 2, 1024, 1024, 96),
                                             (1, 8, 2, 1024, 1024, 128),
                                             (1, 4, 4, 1024, 1024, 192)])
def test_flash_backward_bf16_as_accurate_as_plain_bf16(cuda_device, B, H,
                                                       Hkv, Sq, Sk, Dh):
    """The bfloat16 twin of the float32 rule: against the plain version's
    gradients in float64, each of the kernel's bfloat16 gradients at most
    twice as far as the bfloat16 plain version's."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = torch.randn(B, H, Sq, Dh, generator=g, device=cuda_device)
    k, v = (torch.randn(B, Hkv, Sk, Dh, generator=g, device=cuda_device)
            for _ in range(2))
    dout = torch.randn(B, H, Sq, Dh, generator=g, device=cuda_device)
    q, k, v, dout = (t.bfloat16() for t in (q, k, v, dout))
    got = _flash_grads(q, k, v, dout, lambda *t: flash_attention(
        *t, impl="kernel"))
    plain = _flash_grads(q, k, v, dout, flash_attention_ref)
    exact = _flash_grads(q.double(), k.double(), v.double(), dout,
                         flash_attention_ref)
    for a, p, e in zip(got, plain, exact):
        assert a.dtype == torch.bfloat16
        assert _rel_err(a, e) <= 2 * _rel_err(p, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(cuda_device, dtype):
    """No atomics: two backwards on the same inputs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(1, 9, 1000, 64, generator=g, device=cuda_device)
    k, v = (torch.randn(1, 3, 1000, 64, generator=g, device=cuda_device)
            for _ in range(2))
    dout = torch.randn(1, 9, 1000, 64, generator=g, device=cuda_device)
    q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    run = lambda: _flash_grads(q, k, v, dout, lambda *t: flash_attention(
        *t, impl="kernel"))
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_flash_grad_refuses_unbuilt_head_dim(cuda_device):
    """Under grad an unbuilt head dim raises before any launch."""
    q = torch.randn(1, 2, 8, 24, device=cuda_device, requires_grad=True)
    reset_launches()
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q, impl="kernel")
    assert sum(LAUNCHES.values()) == 0


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


# the reference's swap_gain tolerances on real-valued inputs, as shares of
# the row's largest magnitude (tests/test_torch_kernels.py)
GAIN_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _placed(a, dtype, device, offset=0):
    """``a`` as a contiguous (n, n) view ``offset`` values into its storage:
    a nonzero offset starts it off a 16-byte boundary."""
    buf = torch.zeros(a.size + offset, dtype=dtype, device=device)
    view = buf[offset:].view(a.shape)
    view.copy_(torch.tensor(a, dtype=dtype))
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 16, 33, 200, 1023, 1024, 1025, 4096])
def test_swap_gain_kernel_equals_plain(cuda_device, dtype, n):
    M, G, contrib = (torch.tensor(a, dtype=dtype, device=cuda_device)
                     for a in _select_inputs(n, B=1))
    for i in (0, n // 3, n - 1):
        iv = torch.tensor([i], device=cuda_device)
        got = swap_gain(M[0], G, contrib[0], iv, impl="kernel")
        want = swap_gain_ref(M, G, contrib, iv)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 33, 1023, 1024, 1025, 4096])
def test_swap_gain_kernel_real_valued(cuda_device, dtype, n):
    """Real-valued inputs (the distribution of the reference's float64
    swap_gain test): within the tolerance of the row's largest magnitude."""
    rng = np.random.default_rng(n)
    A = rng.random((n, n))
    S = rng.random((n, n)) * (rng.random((n, n)) < 0.2)
    M = torch.tensor(A + A.T, dtype=dtype, device=cuda_device)
    G = torch.tensor(S + S.T, dtype=dtype, device=cuda_device)
    contrib = (G * M).sum(-1)
    tol = GAIN_TOL[dtype]
    for i in (0, n // 2, n - 1):
        iv = torch.tensor([i], device=cuda_device)
        got = swap_gain(M, G, contrib, iv, impl="kernel")
        want = swap_gain_ref(M[None], G, contrib[None], iv)[0]
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [33, 1024, 1025])
@pytest.mark.parametrize("offsets", [(1, 1), (1, 0), (0, 1)])
def test_swap_gain_kernel_unaligned_views(cuda_device, dtype, n, offsets):
    """M and G as contiguous views that start one value past a 16-byte
    boundary: the kernel reads them one value a load, and its row still
    equals the plain version's bit for bit."""
    Mn, Gn, cn = _select_inputs(n, B=1, seed=3)
    M = _placed(Mn[0], dtype, cuda_device, offsets[0])
    G = _placed(Gn, dtype, cuda_device, offsets[1])
    contrib = torch.tensor(cn[0], dtype=dtype, device=cuda_device)
    assert M.is_contiguous() and G.is_contiguous()
    assert (M.data_ptr() % 16 != 0) == bool(offsets[0])
    for i in (0, n // 3, n - 1):
        iv = torch.tensor([i], device=cuda_device)
        got = swap_gain(M, G, contrib, iv, impl="kernel")
        want = swap_gain_ref(M[None], G, contrib[None], iv)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_valid", [(16, 16), (200, 180), (1024, 1000),
                                       (1025, 1025)])
def test_swap_gain_row_masked_is_swap_select(cuda_device, dtype, n,
                                             n_valid):
    """The gains-row kernel's row with g[i] = 0, the columns from n_valid
    on at -inf, the first-occurrence argmax and the accept rule equals the
    fused swap_select kernel's (gain, j) bit for bit (integer-valued
    inputs): the two kernels compute one function."""
    M, G, contrib = (torch.tensor(a, dtype=dtype, device=cuda_device)
                     for a in _select_inputs(n, B=4, seed=5))
    movers = [0, n // 3, n_valid - 1, n - 1]
    i = torch.tensor(movers, device=cuda_device)
    gain, j = swap_select(M, G, contrib, i, n_valid, impl="kernel")
    for b, mover in enumerate(movers):
        g = swap_gain(M[b], G, contrib[b], i[b:b + 1], impl="kernel")
        g[mover] = 0.0
        g[n_valid:] = float("-inf")
        best = int(torch.argmax(g))
        accept = bool(g[best] > GAIN_EPS) and mover < n_valid
        torch.cuda.synchronize()
        assert torch.equal(gain[b], g[best])
        assert int(j[b]) == (best if accept else mover)


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


def _ssd_grads(ins, dy, dst, fn):
    leaves = [t.detach().requires_grad_(True) for t in ins]
    y, st = fn(*leaves)
    return torch.autograd.grad((y, st), leaves,
                               (dy.to(y.dtype), dst.to(st.dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,P,N,chunk", SSD_SHAPES)
def test_ssd_backward_matches_plain(cuda_device, B, H, G, S, P, N, chunk,
                                    dtype):
    """The gradients of xdt, dA, B and C through _SSDScan (four backward
    launches that recompute the states from the inputs), with a nonzero final
    state's gradient, against autograd of the chunked plain version, as
    shares of each gradient's largest magnitude within the forward's
    tolerances; chunk = S among the shapes."""
    ins = _ssd_inputs(cuda_device, B, H, G, S, P, N, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    dy = torch.randn(B, H, S, P, generator=g, device=cuda_device)
    dst = torch.randn(B, H, P, N, generator=g, device=cuda_device)
    reset_launches()
    got = _ssd_grads(ins, dy, dst, lambda *t: ssd_scan_kernel(
        *t, chunk=chunk, impl="kernel"))
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1 and LAUNCHES["ssd_scan_bwd"] == 1
    want = _ssd_grads(ins, dy, dst, lambda *t: ssd_scan_kernel(
        *t, chunk=chunk, impl="ref"))
    for a, b, t in zip(got, want, ins):
        assert a.dtype == t.dtype
        assert _rel_err(a, b) <= SSD_TOL[dtype]


# (B, H, G, S, P, N, chunk) of the backward's accuracy and determinism
# tests: mamba2's and zamba2's widths (20 and 28 tile blocks of four heads
# a group), G 2 < H 4 (one block a group), and six heads a group (blocks
# of four and two)
SSD_BWD_SHAPES = [(2, 80, 1, 2048, 64, 128, 64), (1, 112, 1, 1024, 64, 64, 64),
                  (2, 4, 2, 128, 32, 32, 32), (1, 12, 2, 256, 64, 64, 64)]


def _ssd_bwd_vs_f64(cuda_device, shape, dtype, seed):
    """(kernel, same-dtype plain version, float64 plain version) gradients
    of xdt, dA, B and C, with a final state's gradient."""
    B, H, G, S, P, N, chunk = shape
    ins = _ssd_inputs(cuda_device, B, H, G, S, P, N, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    dy = torch.randn(B, H, S, P, generator=g, device=cuda_device)
    dst = torch.randn(B, H, P, N, generator=g, device=cuda_device)
    run = lambda impl: _ssd_grads(ins, dy, dst, lambda *t: ssd_scan_kernel(
        *t, chunk=chunk, impl=impl))
    exact = _ssd_grads([t.double() for t in ins], dy, dst,
                       lambda *t: ssd_chunked_folded(*t, chunk))
    return run("kernel"), run("ref"), exact


@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_backward_f32_as_accurate_as_plain_f32(cuda_device, shape):
    """Each float32 gradient at most twice as far from the plain version's
    float64 gradients as the float32 plain version's."""
    got, plain, exact = _ssd_bwd_vs_f64(cuda_device, shape, torch.float32, 9)
    for a, p, e in zip(got, plain, exact):
        assert _rel_err(a, e) <= 2 * _rel_err(p, e)


@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_backward_bf16_as_accurate_as_plain_bf16(cuda_device, shape):
    """Each bfloat16 gradient (bfloat16 inputs, the operands formed in
    float32 as bfloat16 pairs) at most twice as far from the plain
    version's float64 gradients as the bfloat16 plain version's."""
    got, plain, exact = _ssd_bwd_vs_f64(cuda_device, shape, torch.bfloat16,
                                        9)
    for a, p, e in zip(got, plain, exact):
        assert a.dtype == p.dtype
        assert _rel_err(a, e) <= 2 * _rel_err(p, e)


def test_ssd_backward_is_deterministic(cuda_device):
    """dB and dC are summed over a group's heads in head order, with no
    atomics: two backwards give the same bits."""
    ins = _ssd_inputs(cuda_device, 2, 8, 2, 256, 64, 128, torch.float32)
    g = torch.Generator(device=cuda_device).manual_seed(10)
    dy = torch.randn(2, 8, 256, 64, generator=g, device=cuda_device)
    dst = torch.randn(2, 8, 64, 128, generator=g, device=cuda_device)
    run = lambda: _ssd_grads(ins, dy, dst, lambda *t: ssd_scan_kernel(
        *t, chunk=64, impl="kernel"))
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 1, 256, 64, 128, 64),
                                   (1, 12, 2, 256, 64, 64, 64)])
def test_ssd_backward_head_blocks_are_deterministic(cuda_device, shape,
                                                    dtype):
    """Several tile blocks a group (16 heads: four blocks of four) and a
    group whose six heads do not fill its last block: two backwards give
    the same bits in both types."""
    B, H, G, S, P, N, chunk = shape
    ins = _ssd_inputs(cuda_device, B, H, G, S, P, N, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(10)
    dy = torch.randn(B, H, S, P, generator=g, device=cuda_device)
    dst = torch.randn(B, H, P, N, generator=g, device=cuda_device)
    run = lambda: _ssd_grads(ins, dy, dst, lambda *t: ssd_scan_kernel(
        *t, chunk=chunk, impl="kernel"))
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,P,N,chunk", [
    (1, 4, 1, 128, 64, 64, 64),
    (2, 112, 1, 2048, 64, 64, 64),    # zamba2-7b, B 2 x 2048
])
def test_ssd_kernel_zamba2_state_matches_plain(cuda_device, B, H, G, S, P,
                                               N, chunk, dtype):
    """d_state 64 runs the kernel's generic instance (padded to P = N =
    128): against the exact recurrence, and the chunked algorithm in
    float32."""
    xdt, dA, Bm, Cm = _ssd_inputs(cuda_device, B, H, G, S, P, N, dtype)
    reset_launches()
    y, st = ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk, impl="kernel")
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    tol = SSD_TOL[dtype]
    want = [ssd_scan_ref(xdt, dA, Bm, Cm, chunk)]
    if dtype == torch.float32:
        want.append(ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk, impl="ref"))
    for y_r, st_r in want:
        torch.testing.assert_close(y.float(), y_r.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(st, st_r, atol=tol, rtol=tol)


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


@pytest.mark.parametrize("arch,layers,launches", [
    ("zamba2-7b", 7, {"ssd_scan": 7, "flash_attention": 1}),
    ("minicpm3-4b", 2, {"ssd_scan": 0, "flash_attention": 2}),
])
def test_cut_depth_forward_kernels_match_plain(cuda_device, arch, layers,
                                               launches):
    """zamba2-7b (one group of 6 mamba2 layers, the shared block, one
    trailing layer) and minicpm3-4b (two MLA layers) at full width, B 1 x
    2048 (the flash branch), through the kernels against the same
    forward through the plain versions."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    model = M.init(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (1, 2048), device=cuda_device)
    reset_launches()
    with torch.inference_mode():
        got = model(toks, impl="kernel")
        launched = {k: LAUNCHES[k] for k in launches}
        want = model(toks, impl="ref")
    assert launched == launches
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_moe_ffn_local_on_card_matches_cpu(cuda_device):
    """The MoE FFN (64 experts top-6 plus 2 shared, d_model 256, experts
    of 128) on the card against the same layer on the CPU: the same
    routes, outputs within 1e-5."""
    from repro_torch.models import moe
    cfg = reduced(get_arch("deepseek-v2-lite-16b"), d_model=256)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=64, top_k=6, n_shared=2, d_ff_expert=128))
    sch = moe.moe_schema(cfg, 1)
    g = torch.Generator().manual_seed(7)
    blocks = {}
    for dev in ("cpu", cuda_device):
        blocks[str(dev)] = M.DenseBlock({k: d.shape[1:] for k, d in
                                         sch.items()}, device=dev,
                                        dtype=torch.float32)
    with torch.no_grad():
        for name, d in sch.items():
            w = torch.randn(d.shape[1:], generator=g) * d.scale
            for blk in blocks.values():
                getattr(blk, name).copy_(w)
    x = torch.randn((2, 300, cfg.d_model), generator=g)
    with torch.inference_mode():
        want = moe.moe_ffn_local(blocks["cpu"], x, cfg)
        got = moe.moe_ffn_local(blocks[str(cuda_device)], x.to(cuda_device),
                                cfg)
        ids_cpu = moe.route(x.reshape(-1, cfg.d_model)
                            @ blocks["cpu"].router, 6)[1]
        ids_card = moe.route(x.to(cuda_device).reshape(-1, cfg.d_model)
                             @ blocks[str(cuda_device)].router, 6)[1]
    assert torch.equal(ids_card.sort(-1).values.cpu(),
                       ids_cpu.sort(-1).values)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,over,Dh", [
    ("deepseek-v2-lite-16b", dict(n_heads=4), 192),
    ("phi3.5-moe-42b", dict(n_heads=8, n_kv_heads=2, head_dim=128), 128),
])
def test_moe_forward_kernel_matches_plain(cuda_device, arch, over, Dh):
    """Reduced MoE models with their own attention head dims, B 1 x 2048
    (the flash branch): deepseek-v2-lite's MLA (qk 128 + 64, V padded from
    128 to 192) through the float32 Dh 192 instance, phi3.5-moe's GQA
    through the Dh 128 one; held to the plain version's forward by the
    routing rule of chip_smoke.py's MoE cells (``routing_verdict``): a
    token routed to other experts must be a near-tie of the router unless
    an earlier flip of its row reaches it, and the logits before each
    row's first flip agree within 1e-4."""
    chip_smoke = _chip_smoke()
    cfg = reduced(get_arch(arch), **over)
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=get_arch(arch).mla)
    model = M.init(cfg, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (1, 2048), generator=g,
                         device=cuda_device)
    got_routes, want_routes = [], []
    reset_launches()
    with torch.inference_mode():
        with chip_smoke.recording_routes(got_routes):
            got = model(toks, impl="kernel")
        launched, shape = LAUNCHES["flash_attention"], SHAPES[
            "flash_attention"]
        with chip_smoke.recording_routes(want_routes):
            want = model(toks, impl="ref")
    assert launched == cfg.n_layers and shape[-1] == Dh
    assert got_routes and len(got_routes) == len(want_routes)
    verdict = chip_smoke.routing_verdict(
        chip_smoke.by_position(got_routes, 1),
        chip_smoke.by_position(want_routes, 1), got, want,
        cfg.moe.first_dense)
    assert verdict["ok"], verdict


# reduced VLM (4 groups of 4 self layers and a cross layer) and
# encoder-decoder (2 + 3 layers) models with their own head dims and heads
CROSS_MODELS = [
    ("llama-3.2-vision-11b",
     dict(n_layers=20, cross_attn_every=4, n_heads=8, n_kv_heads=2,
          head_dim=128), 16, 128),
    ("seamless-m4t-large-v2",
     dict(n_enc_layers=2, n_layers=3, n_heads=4, n_kv_heads=4, head_dim=64,
          n_audio_frames=300), 3, 64),
]


def _source(cfg, B, device):
    """Seeded source embeddings: a VLM's vision tokens, an encoder-decoder
    model's frames, as a ``forward`` keyword."""
    g = torch.Generator().manual_seed(3)
    if cfg.family == "vlm":
        shape, key = (B, cfg.n_vision_tokens, cfg.d_model), "vision_embed"
    else:
        shape, key = (B, cfg.n_audio_frames, cfg.d_model), "enc_embed"
    return {key: torch.randn(shape, generator=g).to(device)}


@pytest.mark.parametrize("arch,over,self_layers,Dh", CROSS_MODELS)
def test_cross_models_forward_kernel_matches_plain(cuda_device, arch, over,
                                                   self_layers, Dh):
    """B 1 x 2048 (the flash branch): the flash kernel runs once per
    causal self-attention layer, never for a cross-attention or the
    encoder; the logits are held to the plain version's forward."""
    cfg = reduced(get_arch(arch), **over)
    model = M.init(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (1, 2048), device=cuda_device)
    src = _source(cfg, 1, cuda_device)
    reset_launches()
    with torch.inference_mode():
        got = model(toks, impl="kernel", **src)
        launched, shape = LAUNCHES["flash_attention"], SHAPES[
            "flash_attention"]
        want = model(toks, impl="ref", **src)
    assert launched == self_layers and shape[-1] == Dh
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,over,self_layers,Dh", CROSS_MODELS)
def test_cross_models_decode_on_card_matches_forward(cuda_device, arch, over,
                                                     self_layers, Dh):
    """Eight decode steps on the card from empty self caches, the cross
    cache built by ``prefill_cross_cache`` (after ``encode``), held to the
    forward's logits at the same positions."""
    from repro_torch.serve.decode import (decode_step, encode,
                                          prefill_cross_cache)
    from repro_torch.serve.kvcache import init_cache
    cfg = reduced(get_arch(arch), **over)
    model = M.init(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 8), device=cuda_device)
    src = _source(cfg, 2, cuda_device)
    (key, emb), = src.items()
    with torch.inference_mode():
        fwd = model(toks, **src)
    caches = init_cache(cfg, 2, 8, device=cuda_device,
                        src_len=emb.shape[1] if key == "enc_embed" else None)
    caches["cross"] = (prefill_cross_cache(model, emb) if key ==
                       "vision_embed" else prefill_cross_cache(
                           model, encode(model, emb), which="decoder"))
    for t in range(8):
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        torch.testing.assert_close(got[:, 0], fwd[:, t], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_cross_models_serve_main_on_card(cuda_device, capsys, arch):
    assert serve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    assert capsys.readouterr().out.count("\n") == 3


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "phi3.5-moe-42b"])
def test_moe_serve_main_on_card(cuda_device, capsys, arch):
    assert serve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    assert capsys.readouterr().out.count("\n") == 3


@pytest.mark.parametrize("arch", ["zamba2-7b", "minicpm3-4b"])
def test_hybrid_and_mla_serve_main_on_card(cuda_device, capsys, arch):
    assert serve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    assert capsys.readouterr().out.count("\n") == 3


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
    chip_smoke = _chip_smoke()
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


def test_train_step_on_card_matches_cpu(cuda_device):
    """One step of ``make_train_step`` on reduced smollm-135m (B 2 x 64,
    the plain attention, no kernel) on the card, held to the same step
    on the CPU within 1e-5: the loss, the gradient norm, every gradient
    of the same weights, and every parameter after the step but those
    whose clipped gradient g' is within 100 eps of 0.  There AdamW's
    normalised step g' / (|g'| + eps) turns a rounding difference of g'
    into any share of the step, so such a parameter is held to twice the
    step's size, 2 lr, instead."""
    from repro_torch import interop
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import loss_fn, make_train_step

    cfg = reduced(get_arch("smollm-135m"))
    weights = interop.seeded_params(cfg, seed=0)
    batch = SyntheticDataset(cfg.vocab, 64, 2, seed=0).batch(0)
    opt = AdamW(lr=1e-3, warmup_steps=1)
    out = []
    for dev in ("cpu", cuda_device):
        model = interop.model_params(cfg, weights, device=dev)
        ps = dict(model.named_parameters())
        grads = torch.autograd.grad(loss_fn(model, batch), list(ps.values()))
        reset_launches()
        _, m = make_train_step(cfg, opt)(model, opt.init(model), batch)
        assert sum(LAUNCHES.values()) == 0
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: g.cpu() for k, g in zip(ps, grads)},
                    {k: t.detach().cpu() for k, t in ps.items()}))
    (loss, gnorm, grads, params), (c_loss, c_gnorm, c_grads, c_params) = out
    assert c_loss == pytest.approx(loss, rel=1e-5)
    assert c_gnorm == pytest.approx(gnorm, rel=1e-5)
    scale = min(1.0, opt.grad_clip / (gnorm + 1e-9))
    for k, t in params.items():
        torch.testing.assert_close(c_grads[k], grads[k], atol=1e-5,
                                   rtol=1e-5)
        near = (grads[k] * scale).abs() < 100 * opt.eps
        torch.testing.assert_close(c_params[k][~near], t[~near], atol=1e-5,
                                   rtol=1e-5)
        assert bool(((c_params[k] - t)[near].abs() <= 2 * opt.lr).all())


@pytest.mark.parametrize("arch,S,kernels", [
    ("mamba2-2.7b", 64, ("ssd_scan",)),           # every mamba2 layer
    ("smollm-135m", 2048, ("flash_attention",)),  # the flash branch
    ("zamba2-7b", 2048, ("ssd_scan", "flash_attention")),
])
def test_train_step_through_kernels_matches_plain(cuda_device, arch, S,
                                                  kernels):
    """The gradients of a reduced model's loss through the kernels and
    their backwards (one of each a layer that reaches it) against the
    same weights' gradients through the plain versions on the card: the
    loss within 1e-5, every gradient within 1e-4 of its largest
    magnitude; then one make_train_step through the kernels is finite."""
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import cross_entropy, make_train_step

    cfg = reduced(get_arch(arch))
    model = M.init(cfg, seed=0, device=cuda_device)
    batch = SyntheticDataset(cfg.vocab, S, 1, seed=0).batch(0)
    toks, labels = (batch[k].to(cuda_device) for k in ("tokens", "labels"))
    ps = list(model.parameters())
    out = {}
    for impl in ("auto", "ref"):
        reset_launches()
        loss = cross_entropy(model(toks, impl=impl), labels)
        out[impl] = (float(loss.detach()), torch.autograd.grad(loss, ps),
                     dict(LAUNCHES))
    (loss, grads, launches), (p_loss, p_grads, p_launches) = \
        out["auto"], out["ref"]
    assert sum(p_launches.values()) == 0
    for name in kernels:
        assert launches[name] > 0
        assert launches[f"{name}_bwd"] == launches[name]
    assert loss == pytest.approx(p_loss, rel=1e-5)
    for a, b in zip(grads, p_grads):
        assert _rel_err(a, b) <= 1e-4
    opt = AdamW()
    _, m = make_train_step(cfg, opt)(model, opt.init(model), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
