"""Kernel parity of the torch port against the reference kernels.

Each plain PyTorch version in ``repro_torch.kernels`` (the CPU path of
its ``ops.py`` wrapper, and the oracle the CUDA kernel is held to on the
card) is checked against the reference's Pallas kernel run in interpret
mode and against the NumPy all-pairs functions.  Where the inputs are
integer-valued every implementation computes exact results and the
comparisons are exact equality; the attention and normalisation kernels
are held within the reference's own kernel-test tolerances.  The CUDA
kernels themselves run only on
a GPU: ``tests/test_torch_cuda.py`` holds them against the plain versions
there.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_tpu)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_ref)
from repro.kernels.hop_dist.kernel import (fattree_hop_tpu,  # noqa: E402
                                           torus_hop_tpu)
from repro.kernels.rmsnorm.kernel import rmsnorm_tpu  # noqa: E402
from repro.kernels.swap_gain.kernel import (swap_gain_tpu,  # noqa: E402
                                            swap_select_tpu)
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.hop_dist import ops as hop_ops  # noqa: E402
from repro_torch.kernels.hop_dist.ref import (  # noqa: E402
    fattree_hop_pairs_ref, torus_hop_pairs_ref)
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.swap_gain.ops import (swap_gain,  # noqa: E402
                                               swap_select)
from repro_torch.kernels.swap_gain.ref import (GAIN_EPS,  # noqa: E402
                                               swap_select_ref)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors: intra-op threads only contend across workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- hop_dist
TORUS_CASES = [
    ((8, 8, 8), 37, 53),       # ragged
    ((32, 32, 16), 256, 128),  # the implicit 16k-node torus extents
    ((5, 7), 12, 12),          # 2-D, non-pow2 extents
    ((2, 3, 4, 3), 9, 30),     # 4-D
]


@pytest.mark.parametrize("dims,m,k", TORUS_CASES)
def test_torus_hop_ref_matches_pallas_and_numpy(dims, m, k):
    rng = np.random.default_rng(0)
    cu = np.stack([rng.integers(0, d, m) for d in dims], 1).astype(np.float32)
    cv = np.stack([rng.integers(0, d, k) for d in dims], 1).astype(np.float32)
    want = hop_ops.torus_hop_pairs_np(cu, cv, dims).astype(np.float32)
    pallas = np.asarray(torus_hop_tpu(jnp.asarray(cu), jnp.asarray(cv),
                                      dims, interpret=True))
    got = hop_ops.torus_hop(torch.from_numpy(cu), torch.from_numpy(cv), dims)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got.numpy(), want)
    # batched form: each candidate's block equals its unbatched block
    cu_b = torch.from_numpy(np.stack([cu, cu[::-1].copy()]))
    cv_b = torch.from_numpy(np.stack([cv, cv[::-1].copy()]))
    got_b = hop_ops.torus_hop(cu_b, cv_b, dims)
    np.testing.assert_array_equal(got_b[0].numpy(), want)
    np.testing.assert_array_equal(got_b[1].numpy(),
                                  want[::-1, ::-1])


@pytest.mark.parametrize("k,m,kk", [(4, 16, 16), (6, 37, 53), (8, 128, 100)])
def test_fattree_hop_ref_matches_pallas_and_numpy(k, m, kk):
    from repro.core.fattree import FatTreeTopology
    topo = FatTreeTopology(k)
    c = topo.coords_array().astype(np.float32)
    rng = np.random.default_rng(0)
    u = rng.integers(0, topo.n_nodes, m)
    v = rng.integers(0, topo.n_nodes, kk)
    want = topo.hop_matrix()[np.ix_(u, v)].astype(np.float32)
    np.testing.assert_array_equal(hop_ops.fattree_hop_pairs_np(c[u], c[v]),
                                  want)
    pallas = np.asarray(fattree_hop_tpu(jnp.asarray(c[u]), jnp.asarray(c[v]),
                                        interpret=True))
    got = hop_ops.fattree_hop(torch.from_numpy(c[u]), torch.from_numpy(c[v]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got.numpy(), want)
    got64 = fattree_hop_pairs_ref(torch.from_numpy(c[u]).double(),
                                  torch.from_numpy(c[v]).double())
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy(), want)


def test_numpy_hop_copies_match_reference():
    """The port's own NumPy copies equal the reference's functions."""
    from repro.kernels.hop_dist import ops as ref_ops
    rng = np.random.default_rng(3)
    dims = (6, 5, 4)
    cu = np.stack([rng.integers(0, d, 50) for d in dims], 1)
    cv = np.stack([rng.integers(0, d, 40) for d in dims], 1)
    np.testing.assert_array_equal(hop_ops.torus_hop_pairs_np(cu, cv, dims),
                                  ref_ops.torus_hop_pairs_np(cu, cv, dims))
    fu = rng.integers(0, 3, (50, 3))
    fv = rng.integers(0, 3, (40, 3))
    np.testing.assert_array_equal(hop_ops.fattree_hop_pairs_np(fu, fv),
                                  ref_ops.fattree_hop_pairs_np(fu, fv))


# ------------------------------------------------------------ swap_select
def _select_inputs(n, B=3, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 7, (B, n, n)).astype(np.float32)
    M = A + A.transpose(0, 2, 1)
    Bm = rng.integers(0, 5, (n, n)) * (rng.random((n, n)) < 0.3)
    G = (Bm + Bm.T).astype(np.float32)
    contrib = (G[None] * M).sum(-1)
    return M, G, contrib


def _oracle(M, G, contrib, i, n_valid):
    """Composed NumPy oracle: full gains row, mask, argmax, accept."""
    g = (contrib[i] + contrib - 2.0 * G[i] * M[i] - M @ G[i] - G @ M[i])
    g[i] = 0.0
    g[n_valid:] = -np.inf
    j = int(np.argmax(g))
    gain = float(g[j])
    if not (gain > np.float32(GAIN_EPS) and i < n_valid):
        j = i
    return gain, j


@pytest.mark.parametrize("n,n_valid,block_rows", [
    (16, 16, 8), (64, 64, 64), (200, 180, 64), (300, 256, 128)])
def test_swap_select_ref_matches_pallas(n, n_valid, block_rows):
    """Batched plain version == Pallas interpret == NumPy oracle, for
    several movers per candidate, including first-occurrence ties."""
    M, G, contrib = _select_inputs(n)
    B = M.shape[0]
    pallas = jax.jit(functools.partial(swap_select_tpu,
                                       block_rows=block_rows,
                                       interpret=True))
    for movers in ((0, n // 3, n_valid - 1), (n - 1, 1, n // 2)):
        i = np.array(movers, dtype=np.int64)
        gain, j = swap_select_ref(torch.from_numpy(M), torch.from_numpy(G),
                                  torch.from_numpy(contrib),
                                  torch.from_numpy(i), n_valid)
        assert gain.dtype == torch.float32 and j.dtype == torch.int64
        for b in range(B):
            want_gain, want_j = _oracle(M[b], G, contrib[b], int(i[b]),
                                        n_valid)
            pg, pj = pallas(jnp.asarray(M[b]), jnp.asarray(G),
                            jnp.asarray(contrib[b]), jnp.int32(i[b]),
                            jnp.int32(n_valid))
            assert int(j[b]) == want_j == int(pj), (n, b, int(i[b]))
            assert float(gain[b]) == want_gain == float(pg), (n, b)


def test_swap_select_rejects_all_negative():
    """No positive gain anywhere -> j == i (identity swap)."""
    n = 32
    M = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    G = M.copy()
    contrib = (G * M).sum(1)
    i = torch.tensor([3, 0, 31])
    Mt = torch.from_numpy(np.stack([M] * 3))
    gain, j = swap_select_ref(Mt, torch.from_numpy(G),
                              torch.from_numpy(np.stack([contrib] * 3)), i, n)
    assert j.tolist() == [3, 0, 31]
    _, pj = swap_select_tpu(jnp.asarray(M), jnp.asarray(G),
                            jnp.asarray(contrib), jnp.int32(3),
                            jnp.int32(n), interpret=True)
    assert int(pj) == 3
    assert (gain <= GAIN_EPS).all()


def test_swap_select_padding_mover_keeps_j():
    """A padding mover (i >= n_valid) is always rejected (j == i) and
    reports the masked best exactly as the reference kernel does."""
    n, n_valid = 64, 40
    M, G, contrib = _select_inputs(n, B=2, seed=4)
    i = np.array([50, 63])
    gain, j = swap_select(torch.from_numpy(M), torch.from_numpy(G),
                          torch.from_numpy(contrib), torch.from_numpy(i),
                          n_valid)
    assert j.tolist() == [50, 63]
    for b in range(2):
        pg, pj = swap_select_tpu(jnp.asarray(M[b]), jnp.asarray(G),
                                 jnp.asarray(contrib[b]), jnp.int32(i[b]),
                                 jnp.int32(n_valid), interpret=True)
        assert int(pj) == int(i[b])
        assert float(gain[b]) == float(pg)


# ------------------------------------------------------------- dispatch
def test_cpu_tensors_run_plain_version_without_launching():
    reset_launches()
    c = torch.zeros(4, 3, dtype=torch.float64)
    hop_ops.torus_hop(c, c, (4, 4, 4))
    hop_ops.fattree_hop(c, c)
    M, G, contrib = _select_inputs(8, B=1)
    swap_select(torch.from_numpy(M), torch.from_numpy(G),
                torch.from_numpy(contrib), torch.tensor([0]), 8)
    assert LAUNCHES == {"swap_select": 0, "torus_hop": 0, "fattree_hop": 0,
                        "swap_gain": 0, "flash_attention": 0, "rmsnorm": 0,
                        "ssd_scan": 0, "flash_attention_bwd": 0,
                        "ssd_scan_bwd": 0}


def test_kernel_impl_refuses_cpu_tensors():
    """impl='kernel' never quietly runs the plain version."""
    c = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        hop_ops.torus_hop(c, c, (4, 4, 4), impl="kernel")
    with pytest.raises(ValueError):
        hop_ops.fattree_hop(c, c, impl="kernel")
    M, G, contrib = _select_inputs(8, B=1)
    with pytest.raises(ValueError):
        swap_select(torch.from_numpy(M), torch.from_numpy(G),
                    torch.from_numpy(contrib), torch.tensor([0]), 8,
                    impl="kernel")
    with pytest.raises(ValueError):
        hop_ops.torus_hop(c, c, (4, 4, 4), impl="fast")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """A build without a compiler raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError):
        _build._nvcc()


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """A source's library is named by a digest that also covers the
    package's shared headers, so an edited header gets a new build."""
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    header = tmp_path / "sm_count.cuh"
    header.write_text("// one\n")
    first = _build._so_path("swap_gain")
    assert _build._so_path("swap_gain") == first
    header.write_text("// two\n")
    assert _build._so_path("swap_gain") != first
    assert _build.INCLUDE_FLAGS[0] == "-I"


def test_count_launch_keeps_largest_shape():
    from repro_torch.kernels import SHAPES, count_launch
    reset_launches()
    count_launch("torus_hop", (2, 8, 8))
    count_launch("torus_hop", (1, 4, 4))
    assert LAUNCHES["torus_hop"] == 2 and SHAPES["torus_hop"] == (2, 8, 8)
    reset_launches()
    assert LAUNCHES["torus_hop"] == 0 and SHAPES["torus_hop"] is None


def test_build_dir_choice(monkeypatch, tmp_path):
    """Explicit directory first, then the checkout's build/, then the
    user's cache directory for an installed package."""
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    checkout = tmp_path / "co"
    (checkout / "src" / "repro_torch" / "kernels").mkdir(parents=True)
    (checkout / "pyproject.toml").write_text("")
    monkeypatch.setattr(_build, "_PKG",
                        checkout / "src" / "repro_torch" / "kernels")
    assert _build._build_dir() == checkout / "build" / "torch_ext"
    site = tmp_path / "lib" / "site-packages" / "repro_torch" / "kernels"
    site.mkdir(parents=True)
    monkeypatch.setattr(_build, "_PKG", site)
    assert _build._build_dir() == tmp_path / "cache" / "repro_torch" \
        / "torch_ext"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "mine"))
    assert _build._build_dir() == tmp_path / "mine"


# ------------------------------------------------------------ swap_gain

# the reference's kernel-test tolerances (tests/test_kernels.py TOL)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _gain_inputs(n, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        A = rng.integers(0, 7, (n, n)).astype(np.float64)
        S = (rng.integers(0, 5, (n, n))
             * (rng.random((n, n)) < 0.3)).astype(np.float64)
    else:
        A, S = rng.random((n, n)), rng.random((n, n)) * (
            rng.random((n, n)) < 0.2)
    M, G = A + A.T, S + S.T
    return M, G, (G * M).sum(1)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,block_rows", [(64, 64), (200, 64), (256, 128)])
def test_swap_gain_matches_pallas_f64(n, block_rows, integer):
    """float64: exact with integer-valued inputs, rtol 1e-12 otherwise."""
    M, G, contrib = _gain_inputs(n, integer)
    for i in (0, n // 2, n - 1):
        got = swap_gain(torch.from_numpy(M), torch.from_numpy(G),
                        torch.from_numpy(contrib), i)
        assert got.dtype == torch.float64 and got.shape == (n,)
        with jax.enable_x64(True):
            want = np.asarray(swap_gain_tpu(
                jnp.asarray(M), jnp.asarray(G), jnp.asarray(contrib),
                jnp.int32(i), block_rows=block_rows, interpret=True))
        assert want.dtype == np.float64
        if integer:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())


def test_swap_gain_row_feeds_swap_select():
    """The unfused row, masked and reduced, is the fused select's answer."""
    M, G, contrib = _gain_inputs(48, True, seed=2)
    Mt, Gt, ct = (torch.from_numpy(a) for a in (M, G, contrib))
    for i in (0, 17, 47):
        g = swap_gain(Mt, Gt, ct, torch.tensor(i))
        g[i] = 0.0
        gain, j = swap_select(Mt[None], Gt, ct[None], torch.tensor([i]), 48)
        assert float(gain[0]) == float(g.max())
        assert int(j[0]) == (int(g.argmax()) if g.max() > GAIN_EPS else i)


# ---------------------------------------------------------------- flash
FLASH_CASES = [
    (1, 2, 2, 64, 64, 32, True),
    (2, 4, 2, 96, 96, 64, True),      # GQA + non-pow2 seq (padding)
    (1, 4, 1, 32, 128, 64, True),     # decode-ish: Sq < Sk, MQA
    (2, 2, 2, 64, 64, 128, False),    # non-causal (cross attention)
    (1, 8, 4, 200, 200, 64, True),    # ragged tail
    (1, 9, 3, 128, 128, 64, True),    # smollm's 9 heads over 3 KV heads
]


def _qkv(B, H, Hkv, Sq, Sk, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, Dh), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, Dh), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, Dh), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh,causal", FLASH_CASES)
def test_flash_ref_matches_pallas(B, H, Hkv, Sq, Sk, Dh, causal, dtype):
    """The plain version (several blocks, and its default blocks) against
    the Pallas kernel in interpret mode and the reference's own plain
    version, on the same inputs (bfloat16 rounded alike in both)."""
    arrs = _qkv(B, H, Hkv, Sq, Sk, Dh)
    jq, jk, jv = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs)
    pallas = np.asarray(flash_attention_tpu(jq, jk, jv, causal=causal,
                                            block_q=32, block_k=32,
                                            interpret=True), np.float32)
    jref = np.asarray(jax_flash_ref(jq, jk, jv, causal=causal),
                      np.float32)
    tol = TOL[dtype]
    for got in (flash_attention_ref(tq, tk, tv, causal=causal, q_block=16,
                                    kv_block=32),
                flash_attention(tq, tk, tv, causal=causal)):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        got = got.float().numpy()
        np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, jref, atol=tol, rtol=tol)


def _flash_bf16_design(q, k, v, causal, block_k=64):
    """The arithmetic of the bfloat16 tensor-core flash kernel: scores and
    sums in float32 from bfloat16 operands, an online softmax over tiles of
    ``block_k`` keys in the log2 domain, the row sum of the float32
    probabilities, and P rounded to bfloat16 for the P V product."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(H // Hkv, dim=1)
    v = v.float().repeat_interleave(H // Hkv, dim=1)
    q = q.float()
    scale = 1.4426950408889634 / np.sqrt(Dh)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, Dh))
    qpos = torch.arange(Sq) + Sk - Sq
    for k0 in range(0, Sk, block_k):
        kpos = torch.arange(k0, min(Sk, k0 + block_k))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, kpos]) * scale
        if causal:
            s = torch.where(kpos[None, :] <= qpos[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), v[:, :, kpos])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).bfloat16()


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh,causal", FLASH_CASES + [
    (1, 2, 2, 100, 100, 192, True),   # the key tile of 32 at Dh 192, 256
    (1, 2, 1, 65, 190, 256, True),
    (1, 4, 2, 40, 300, 192, True),
])
def test_flash_bf16_rounding_of_p_holds_tolerance(B, H, Hkv, Sq, Sk, Dh,
                                                  causal):
    """Rounding P to bfloat16 before P V, as the tensor-core kernel does,
    keeps the output within the reference's bfloat16 tolerance of the
    Pallas kernel in interpret mode and of the reference's plain version."""
    arrs = _qkv(B, H, Hkv, Sq, Sk, Dh)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrs)
    got = _flash_bf16_design(tq, tk, tv, causal,
                             block_k=64 if Dh <= 128 else 32)
    got = got.float().numpy()
    for want in (flash_attention_tpu(jq, jk, jv, causal=causal, block_q=32,
                                     block_k=32, interpret=True),
                 jax_flash_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def _tf32_rna(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (and the float32
    kernel's integer form of it): to nearest, ties away from zero, keeping
    10 explicit mantissa bits (float32's low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x):
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _tf32_product(a, b, products):
    """a @ b from TF32 halves, as the float32 kernel's tensor-core products:
    big x big, plus (with three products) the two cross terms; each product
    of TF32 values is exact in float32, the sums are float32's."""
    ab, as_ = _split_tf32(a)
    bb, bs = _split_tf32(b)
    out = ab @ bb
    if products == 3:
        out = out + (as_ @ bb + ab @ bs)
    return out


def _flash_3xtf32_design(q, k, v, causal, block_k=64, products=3):
    """The arithmetic of the float32 tensor-core flash kernel: Q, K, V and P
    split into TF32 halves, each product as three TF32 products summed in
    float32 (``products=1``: big x big alone, plain TF32), and the online
    softmax in the log2 domain over tiles of ``block_k`` keys."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(H // Hkv, dim=1)
    v = v.float().repeat_interleave(H // Hkv, dim=1)
    q = q.float()
    scale = torch.tensor(1.4426950408889634 / np.sqrt(Dh),
                         dtype=torch.float32)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, Dh))
    qpos = torch.arange(Sq) + Sk - Sq
    for k0 in range(0, Sk, block_k):
        kpos = torch.arange(k0, min(Sk, k0 + block_k))
        s = _tf32_product(q, k[:, :, kpos].transpose(-1, -2),
                          products) * scale
        if causal:
            s = torch.where(kpos[None, :] <= qpos[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _tf32_product(p, v[:, :, kpos],
                                                    products)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


# the key tile of the float32 kernel at each head dim
F32_BLOCK_K = {16: 64, 32: 64, 64: 64, 96: 64, 112: 32, 128: 32, 192: 32,
               256: 16}
F32_DESIGN_CASES = FLASH_CASES + [
    (1, 2, 1, 70, 300, 96, True),     # minicpm3's head dim: Sq < Sk, ragged
    (1, 8, 8, 130, 130, 96, True),
    (1, 4, 4, 130, 130, 112, False),  # zamba2's head dim, non-causal
    (1, 2, 1, 70, 300, 112, True),
    (1, 2, 2, 100, 100, 192, True),
    (1, 2, 1, 65, 190, 256, True),
]


def _f32_design_vs_references(case, products):
    """(largest error from the Pallas kernel in interpret mode, largest
    error from the reference's plain version) of the design on ``case``."""
    B, H, Hkv, Sq, Sk, Dh, causal = case
    arrs = _qkv(B, H, Hkv, Sq, Sk, Dh)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    got = _flash_3xtf32_design(tq, tk, tv, causal,
                               block_k=F32_BLOCK_K[Dh],
                               products=products).numpy()
    wants = (flash_attention_tpu(jq, jk, jv, causal=causal, block_q=32,
                                 block_k=32, interpret=True),
             jax_flash_ref(jq, jk, jv, causal=causal))
    return tuple(float(np.abs(got - np.asarray(w, np.float32)).max())
                 for w in wants), got, wants


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh,causal", F32_DESIGN_CASES)
def test_flash_3xtf32_design_holds_float32_tolerance(B, H, Hkv, Sq, Sk, Dh,
                                                     causal):
    """Three TF32 products for each float32 one, as the float32 tensor-core
    kernel computes them, keep the output within the reference's float32
    tolerance of the Pallas kernel in interpret mode and of the
    reference's plain version."""
    _, got, wants = _f32_design_vs_references(
        (B, H, Hkv, Sq, Sk, Dh, causal), products=3)
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("x,want", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),           # a tie: away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),     # negative tie
    (1 + 3 * 2.0 ** -12, 1 + 2.0 ** -10),       # above half an ulp: up
    (1 + 2.0 ** -12, 1.0),                      # below half an ulp: down
    (2 - 2.0 ** -12, 2.0),                      # a carry into the exponent
    (0.0, 0.0),
    (-0.0, -0.0),
    (3.0, 3.0),                                 # already TF32
])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = _tf32_rna(torch.tensor([x], dtype=torch.float32))
    want = torch.tensor([want], dtype=torch.float32)
    assert got.view(torch.int32).item() == want.view(torch.int32).item()
    big, small = _split_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(big) + float(small) == x      # exact: x has 13 bits


def test_flash_single_tf32_misses_float32_tolerance():
    """One TF32 product (big x big alone, what the tensor cores give a
    float32 product with TF32 on) misses the reference's float32 tolerance
    on cases where three products hold it (the test above): the reason
    the kernel pays for three."""
    worst = {case: max(_f32_design_vs_references(case, products=1)[0])
             for case in F32_DESIGN_CASES[:3]}
    assert max(worst.values()) > TOL["float32"], worst


# -------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 128), (130, 256),
                                   (5, 576)])
def test_rmsnorm_ref_matches_pallas(shape, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-1:], dtype=np.float32) + 1.0
    pallas = np.asarray(rmsnorm_tpu(jnp.asarray(x, getattr(jnp, dtype)),
                                    jnp.asarray(w, getattr(jnp, dtype)),
                                    block_rows=8, interpret=True),
                        np.float32)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    for got in (rmsnorm_ref(tx, tw), rmsnorm(tx, tw)):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        np.testing.assert_allclose(got.float().numpy(), pallas,
                                   atol=TOL[dtype], rtol=TOL[dtype])


# ------------------------------------------------ dispatch of the new ops
def test_new_ops_on_cpu_run_plain_version_without_launching():
    reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 32))
    flash_attention(q, k, v)
    rmsnorm(q, torch.ones(32))
    M, G, contrib = _gain_inputs(8, True)
    swap_gain(torch.from_numpy(M), torch.from_numpy(G),
              torch.from_numpy(contrib), 3)
    assert all(n == 0 for n in LAUNCHES.values())


@pytest.mark.parametrize("op", ["flash_attention", "rmsnorm", "swap_gain"])
def test_new_ops_kernel_impl_refuses_cpu_tensors(op):
    q = torch.zeros(1, 2, 8, 32)
    M = torch.zeros(8, 8, dtype=torch.float64)
    calls = {
        "flash_attention": lambda: flash_attention(q, q, q, impl="kernel"),
        "rmsnorm": lambda: rmsnorm(q, torch.ones(32), impl="kernel"),
        "swap_gain": lambda: swap_gain(M, M, M[0], 0, impl="kernel"),
    }
    with pytest.raises(ValueError):
        calls[op]()
