"""The backward passes of the port's flash attention and SSD scan, on the CPU.

The CUDA backward kernels (``flash_attention_bwd.cu``, ``ssd_scan_bwd.cu``)
run only on the card.  Here, from the same NumPy inputs:

* the port's plain versions differentiated by autograd against
  ``jax.grad`` of the reference's plain versions (``flash_attention_ref``;
  the chunked ``ssd_chunked`` and the exact recurrence ``ssd_scan_ref``),
  within rtol = atol = 1e-5 in float32 (atol relative to a gradient's
  largest magnitude above 1): the gradients the card's kernels are held
  to are the reference's training gradients;
* a CPU emulation of each backward kernel's blocked algorithm (the flash
  kernel's log-sum-exp, its row pass of l and D, dK/dV over query tiles
  with the GQA sum,
  dQ over KV tiles; the SSD kernels' tile states, their forward and
  reverse passes over the tiles and the per-tile gradient formulas, with
  a nonzero final-state gradient), held to autograd of the plain version
  within 1e-5, as ``test_torch_kernels._flash_3xtf32_design`` holds the
  forward's, and each kernel's tensor-core arithmetic (3xTF32 products in
  float32; bfloat16 operands with the float32-formed ones as bfloat16
  pairs) within twice the same-dtype plain version's float64-referenced
  error;
* each ``autograd.Function``'s wiring (what it saves, the ``None``
  gradients, the group sums) with those emulations injected into the
  port's own ``ops`` modules in place of the launches, through the entry
  points' dispatch;
* a reduced smollm-135m train step at 2048 tokens (the flash branch), its
  loss and every gradient against the reference's, with the plain version
  and through ``_FlashAttention`` on the emulated kernels.

The reference's held-step constants of the card's new train cells are
recomputed in ``tests/test_torch_backward_expected.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_kernels import _tf32_product  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_ref)
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_ref as jax_ssd_ref)
from repro.models import model as ref_model  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.train import train_step as ref_ts  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    _segsum, ssd_chunk_parallel, ssd_chunked_folded, ssd_scan_ref)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.train.train_step import loss_fn  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision_one_thread():
    """float32 products in full float32; one intra-op thread per worker."""
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    """Within rtol ``tol`` and atol ``tol`` times the larger of 1 and the
    gradient's largest magnitude: a gradient summed over many tokens (A's
    over every token of its head) carries float32 rounding in proportion
    to its size in either package."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _leaves(*ts):
    return [torch.from_numpy(t).requires_grad_(True) for t in ts]


# (B, H, Hkv, Sq, Sk, Dh): GQA, causal with Sq = Sk and Sq < Sk
FLASH_CASES = [(1, 4, 2, 96, 96, 64), (2, 4, 1, 64, 160, 64),
               (1, 2, 2, 80, 80, 96), (1, 6, 3, 48, 120, 96)]


def _flash_inputs(B, H, Hkv, Sq, Sk, Dh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return (f(B, H, Sq, Dh), f(B, Hkv, Sk, Dh), f(B, Hkv, Sk, Dh),
            f(B, H, Sq, Dh))


# ------------------------------------------- 1. plain gradients vs jax.grad
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh", FLASH_CASES)
def test_flash_plain_gradients_match_reference(B, H, Hkv, Sq, Sk, Dh):
    """Blocks of 32 queries and 64 keys, so several of each are visited."""
    q, k, v, do = _flash_inputs(B, H, Hkv, Sq, Sk, Dh)
    _, vjp = jax.vjp(lambda *t: jax_flash_ref(*t, causal=True, q_block=32,
                                              kv_block=64),
                     *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _leaves(q, k, v)
    out = flash_attention_ref(tq, tk, tv, causal=True, q_block=32,
                              kv_block=64)
    out.backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w)


def _ssd_model_inputs(B=2, S=96, H=4, P=8, G=2, N=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    x = f(B, S, H, P) * 0.5
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    A = -np.exp(f(H) * 0.3).astype(np.float32)
    Bm, Cm = f(B, S, G, N) * 0.5, f(B, S, G, N) * 0.5
    dy, dst = f(B, S, H, P), f(B, H, P, N)
    return (x, dt, A, Bm, Cm), dy, dst


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_gradients_match_reference(chunk):
    """Model layout, G 2 < H 4, 96 tokens in several chunks: the gradients
    of x, dt, A, B and C, with a nonzero final-state gradient."""
    ins, dy, dst = _ssd_model_inputs()

    def ref_loss(*t):
        y, st = ref_ssm.ssd_chunked(*t, chunk=chunk)
        return (y * dy).sum() + (st * dst).sum()

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(
        *(jnp.asarray(t) for t in ins))
    leaves = _leaves(*ins)
    y, st = ssm.ssd_chunked(*leaves, chunk=chunk)
    ((y * torch.from_numpy(dy)).sum()
     + (st * torch.from_numpy(dst)).sum()).backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w)


def test_ssd_exact_recurrence_gradients_match_reference():
    """The kernel layout's oracle, the one-token recurrence, G 2 < H 4."""
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    b, H, G, S, P, N = 1, 4, 2, 40, 8, 16
    ins = (f(b, H, S, P) * 0.5, -np.log1p(np.exp(f(b, H, S))) * 0.5,
           f(b, G, S, N) * 0.5, f(b, G, S, N) * 0.5)
    ins = tuple(np.asarray(t, np.float32) for t in ins)
    dy, dst = f(b, H, S, P), f(b, H, P, N)

    def ref_loss(*t):
        y, st = jax_ssd_ref(*t, chunk=8)
        return (y * dy).sum() + (st * dst).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t) for t in ins))
    leaves = _leaves(*ins)
    y, st = ssd_scan_ref(*leaves)
    ((y * torch.from_numpy(dy)).sum()
     + (st * torch.from_numpy(dst)).sum()).backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w)


# ------------------------------------- 2. the kernels' blocked algorithms
def _flash_fwd_lse(q, k, v, causal, bk=64):
    """The forward kernel's output and the log-sum-exp its epilogue writes,
    (m + log2 l) ln 2 from the running max m of the log2-domain scores and
    the sum l, over key tiles of ``bk``."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(H // Hkv, dim=1)
    vv = v.repeat_interleave(H // Hkv, dim=1)
    scale_log2 = 1.4426950408889634 / math.sqrt(Dh)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, Dh))
    qpos = torch.arange(Sq) + Sk - Sq
    for k0 in range(0, Sk, bk):
        kpos = torch.arange(k0, min(Sk, k0 + bk))
        s = (q @ kk[:, :, kpos].transpose(-1, -2)) * scale_log2
        if causal:
            s = torch.where(kpos[None, :] <= qpos[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vv[:, :, kpos]
        m = m_new
    return acc / l[..., None], (m + torch.log2(l)) * math.log(2.0)


def _bwd_tiles(Dh, f32=True):
    """The backward kernels' tiles (``Tiles`` in flash_attention_bwd.cu):
    keys a tile of the dQ sweeps (64 query rows a block), and keys a
    block and queries a tile of dK/dV."""
    bk = (32 if Dh <= 128 else 16 if Dh <= 192 else 8) if f32 \
        else (64 if Dh <= 128 else 32)
    keys = 64 if Dh <= 128 else 32
    bq = (16 if 64 < Dh <= 112 or Dh > 192 else 32) if f32 \
        else (64 if Dh <= 64 else 32)
    return dict(bq_dq=64, bk_dq=bk, keys=keys, bq_kv=bq)


def _flash_bwd_design(q, k, v, lse, dout, causal, tiles=None, mm=None,
                      carry=None, dq_step=None):
    """The backward kernels' algorithm.  With e = exp2(x - lse log2(e))
    for the log2-domain scores x: per query tile of ``bq_dq`` rows a first
    sweep over its visible KV tiles of ``bk_dq`` keys sums l = sum e and
    D = sum e dP / l (each tile's sums alone, then added), a second forms
    P = e / l, dS = P o (dP - D) and dS K; per KV tile of ``keys`` keys,
    over the query heads of its group in order and their query tiles of
    ``bq_kv`` from the first that sees the tile, P^T dO and dS^T Q.
    ``mm(a, b)`` is each product (float32 matmul by default), ``carry``
    what P and dS become before theirs; each tile's dS K (each
    ``dq_step`` keys' with one given), P^T dO and dS^T Q are summed alone
    and then added to the totals.  Tiles of ``_bwd_tiles`` by default.
    (dq, dk, dv)."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    t = tiles or _bwd_tiles(Dh)
    mm = mm or torch.matmul
    carry = carry or (lambda x: x)
    g, offset = H // Hkv, Sk - Sq
    scale = 1.0 / math.sqrt(Dh)
    scale_log2 = 1.4426950408889634 / math.sqrt(Dh)
    c = lse * 1.4426950408889634
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)

    def key_tiles(q0, bq, bk):
        n = -(-Sk // bk)
        last = min(q0 + bq, Sq) - 1 + offset
        return n if not causal else (0 if last < 0 else min(n, last // bk + 1))

    def tile(qi, doi, ci, kk, vv, q0, k0):
        """e and dP of query rows from q0 against keys from k0."""
        i = torch.arange(q0, q0 + qi.shape[-2])[:, None]
        j = torch.arange(k0, k0 + kk.shape[-2])[None, :]
        vis = (j <= i + offset) if causal else torch.ones_like(i < j)
        x = mm(qi, kk.transpose(-1, -2)) * scale_log2
        e = torch.where(vis, torch.exp2(x - ci[..., None]), 0.0)
        return e, mm(doi, vv.transpose(-1, -2))

    def ds_of(e, dp, il_i, D_i):
        p = e * il_i[..., None]
        return p, p * (dp - D_i[..., None])

    bq, bk = t["bq_dq"], t["bk_dq"]
    il, D = torch.zeros_like(lse), torch.zeros_like(lse)
    dq = torch.zeros_like(q)
    for q0 in range(0, Sq, bq):
        sl = slice(q0, q0 + bq)
        qi, doi, ci = q[:, :, sl], dout[:, :, sl], c[:, :, sl]
        tot_l = torch.zeros_like(lse[:, :, sl])
        tot_d = torch.zeros_like(lse[:, :, sl])
        for kt in range(key_tiles(q0, bq, bk)):
            k0 = kt * bk
            e, dp = tile(qi, doi, ci, kr[:, :, k0:k0 + bk],
                         vr[:, :, k0:k0 + bk], q0, k0)
            tot_l, tot_d = tot_l + e.sum(-1), tot_d + (e * dp).sum(-1)
        il[:, :, sl], D[:, :, sl] = 1.0 / tot_l, tot_d / tot_l
        tot = torch.zeros_like(qi)
        for kt in range(key_tiles(q0, bq, bk)):
            k0 = kt * bk
            kk = kr[:, :, k0:k0 + bk]
            e, dp = tile(qi, doi, ci, kk, vr[:, :, k0:k0 + bk], q0, k0)
            _, ds = ds_of(e, dp, il[:, :, sl], D[:, :, sl])
            w = dq_step or kk.shape[-2]
            for j0 in range(0, kk.shape[-2], w):
                tot = tot + mm(carry(ds[..., j0:j0 + w]),
                               kk[..., j0:j0 + w, :])
        dq[:, :, sl] = tot * scale

    bkv, bq = t["keys"], t["bq_kv"]
    grp = lambda x: x.reshape(B, Hkv, g, *x.shape[2:])
    qv, dov, cv, ilv, Dv = map(grp, (q, dout, c, il, D))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, Sk, bkv):
        kk, vv = k[:, :, k0:k0 + bkv], v[:, :, k0:k0 + bkv]
        tot_k, tot_v = torch.zeros_like(kk), torch.zeros_like(vv)
        first = max(0, k0 - offset) if causal else 0
        for hh in range(g):
            for q0 in range(first // bq * bq, Sq, bq):
                sl = slice(q0, q0 + bq)
                qi, doi = qv[:, :, hh, sl], dov[:, :, hh, sl]
                e, dp = tile(qi, doi, cv[:, :, hh, sl], kk, vv, q0, k0)
                p, ds = ds_of(e, dp, ilv[:, :, hh, sl], Dv[:, :, hh, sl])
                tot_v = tot_v + mm(carry(p.transpose(-1, -2)), doi)
                tot_k = tot_k + mm(carry(ds.transpose(-1, -2)), qi)
        dk[:, :, k0:k0 + bkv], dv[:, :, k0:k0 + bkv] = tot_k * scale, tot_v
    return dq, dk, dv


def _bf16_pair(x):
    """x carried as the bfloat16 kernel carries P and dS into its
    products: bf16(x) + bf16(x - bf16(x)), each term a bfloat16 value."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _flash_bwd_bf16_design(q, k, v, lse, dout, causal):
    """The bfloat16 kernel's arithmetic: bfloat16 inputs, products summed
    in float32, P and dS as bfloat16 pairs, the bfloat16 tiles;
    gradients rounded to bfloat16."""
    got = _flash_bwd_design(q.float(), k.float(), v.float(), lse,
                            dout.float(), causal,
                            _bwd_tiles(q.shape[-1], f32=False),
                            carry=_bf16_pair)
    return tuple(t.bfloat16() for t in got)


def _flash_bwd_3xtf32_design(q, k, v, lse, dout, causal):
    """The float32 kernel's arithmetic: every product as three TF32
    products (``_tf32_product``, the forward's emulation), dQ's summed 8
    keys at a time and each tile's dK and dV products alone before they
    are added to the totals."""
    return _flash_bwd_design(q, k, v, lse, dout, causal,
                             mm=lambda a, b: _tf32_product(a, b, 3),
                             dq_step=8)


def _plain_flash_grads(q, k, v, do, causal=True):
    leaves = _leaves(q, k, v)
    flash_attention_ref(*leaves, causal=causal).backward(
        torch.from_numpy(do))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh", FLASH_CASES + [
    (1, 3, 1, 40, 40, 192), (1, 2, 1, 129, 257, 64), (1, 2, 2, 65, 65, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_design_matches_autograd(B, H, Hkv, Sq, Sk, Dh,
                                                causal):
    """The backward kernels' algorithm (the float32 instance's tiles,
    ``_bwd_tiles``), from the forward's log-sum-exp, against autograd of
    the plain version; the log-sum-exp against torch.logsumexp."""
    q, k, v, do = _flash_inputs(B, H, Hkv, Sq, Sk, Dh, seed=2)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    block = 64 if Dh <= 128 else 32
    _, lse = _flash_fwd_lse(tq, tk, tv, causal, block)
    _close(lse, _exact_lse(tq, tk, causal))
    got = _flash_bwd_design(tq, tk, tv, lse, tdo, causal)
    for g, w in zip(got, _plain_flash_grads(q, k, v, do, causal)):
        _close(g, w)


def _exact_lse(q, k, causal):
    """Each row's log-sum-exp of its scaled, masked scores, in float64."""
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    s = q.double() @ k.double().repeat_interleave(
        H // k.shape[1], 1).transpose(-1, -2) / math.sqrt(Dh)
    if causal:
        i, j = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
        s = s.masked_fill(j > i + Sk - Sq, -math.inf)
    return torch.logsumexp(s, -1)


def _errors_from_f64(got, q, k, v, do, causal):
    """Each gradient's largest error against the plain version's autograd
    in float64, as a share of its largest magnitude: (kernel's, the plain
    version's in the inputs' dtype) by gradient."""
    def grads(*ts):
        leaves = [t.detach().clone().requires_grad_(True) for t in ts[:3]]
        flash_attention_ref(*leaves, causal=causal).backward(ts[3])
        return [t.grad for t in leaves]

    exact = grads(*(t.double() for t in (q, k, v, do)))
    plain = grads(q, k, v, do)
    out = []
    for a, p, e in zip(got, plain, exact):
        scale = float(e.abs().max())
        out.append((float((a.double() - e).abs().max()) / scale,
                    float((p.double() - e).abs().max()) / scale))
    return out


TC_DESIGN_CASES = FLASH_CASES + [(1, 4, 2, 40, 300, 192),
                                 (1, 4, 2, 129, 129, 64)]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh", TC_DESIGN_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_3xtf32_design_within_twice_plain(B, H, Hkv, Sq, Sk,
                                                         Dh, causal):
    """The float32 tensor-core kernel's arithmetic (3xTF32 products, each
    tile's sums alone, l and D from its own P and dP), held as the
    card holds the kernel: each gradient at most twice as far from the
    plain version's float64 gradients as the float32 plain version's."""
    q, k, v, do = (torch.from_numpy(t) for t in
                   _flash_inputs(B, H, Hkv, Sq, Sk, Dh, seed=7))
    lse = _exact_lse(q, k, causal).float()
    got = _flash_bwd_3xtf32_design(q, k, v, lse, do, causal)
    for kernel, plain in _errors_from_f64(got, q, k, v, do, causal):
        assert kernel <= 2 * plain


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,Dh", TC_DESIGN_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_bf16_design_within_twice_plain(B, H, Hkv, Sq, Sk,
                                                       Dh, causal):
    """The bfloat16 tensor-core kernel's arithmetic (bfloat16 operands, P
    and dS as bfloat16 pairs, float32 sums, bfloat16 gradients), each
    gradient at most twice as far from the plain version's float64
    gradients as the bfloat16 plain version's."""
    q, k, v, do = (torch.from_numpy(t).bfloat16() for t in
                   _flash_inputs(B, H, Hkv, Sq, Sk, Dh, seed=8))
    lse = _exact_lse(q, k, causal).float()
    got = _flash_bwd_bf16_design(q, k, v, lse, do, causal)
    for g in got:
        assert g.dtype == torch.bfloat16
    for kernel, plain in _errors_from_f64(got, q, k, v, do, causal):
        assert kernel <= 2 * plain


def test_bf16_pair_keeps_sixteen_bits():
    """A float32 value carried as two bfloat16 terms keeps about 16 bits:
    within 2^-16 of itself, where one bfloat16 keeps 8 (2^-9)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    rel = lambda y: float(((y - x) / x).abs().max())
    assert rel(_bf16_pair(x)) < 2.0 ** -16
    assert rel(x.bfloat16().float()) > 2.0 ** -10


def _ssd_bwd_design(xdt, dA, B, C, dy, dst, chunk, mm=None, carry=None,
                    pad_to=None):
    """The SSD backward kernels' algorithm on the kernel's layout, in tiles
    of min(chunk, 64) rows.  Per tile, its own state s = (dec o x)^T B and
    its own state gradient r = (e^a o dy)^T C (the decays within the tile);
    then the passes over the tiles, the state entering each tile h_{c+1} =
    e^{a_last} h_c + s_c from zero and the gradient of the state leaving
    it g_{c-1} = e^{a_last} g_c + r_c from ``dst``; then per tile the
    formulas of ``ssd_scan_bwd.cu`` and the in-tile reverse sum of da; dB
    and dC summed over each group's heads in order.  ``mm(a, b)`` is each
    product (float32 matmul by default), ``carry`` what an operand formed
    in float32 (the decayed rows, W, V, h and g) becomes before its
    product; ``pad_to`` (P, N) pads P and N with zeros, as the kernel's
    instances do.  (dxdt, ddA, dB, dC)."""
    mm = mm or torch.matmul
    carry = carry or (lambda t: t)
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    if pad_to is not None:
        zp = lambda t, n: torch.nn.functional.pad(t, (0, n - t.shape[-1]))
        got = _ssd_bwd_design(zp(xdt, pad_to[0]), dA, zp(B, pad_to[1]),
                              zp(C, pad_to[1]), zp(dy, pad_to[0]),
                              None if dst is None else torch.nn.functional.pad(
                                  dst, (0, pad_to[1] - N, 0, pad_to[0] - P)),
                              chunk, mm, carry)
        return (got[0][..., :P], got[1], got[2][..., :N], got[3][..., :N])
    rep, T = H // G, min(chunk, 64)
    nT = -(-S // T)
    pad = nT * T - S
    rows = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
    x = rows(xdt).reshape(b, H, nT, T, P)
    y = rows(dy).reshape(b, H, nT, T, P)
    da_t = torch.nn.functional.pad(dA, (0, pad)).reshape(b, H, nT, T)
    a = torch.cumsum(da_t, -1)
    Bh = rows(B.repeat_interleave(rep, 1)).reshape(b, H, nT, T, N)
    Ch = rows(C.repeat_interleave(rep, 1)).reshape(b, H, nT, T, N)
    ex, last = torch.exp(a), a[..., -1]
    dec = torch.exp(last[..., None] - a)
    T_ = lambda t: t.transpose(-1, -2)
    s_own = mm(T_(carry(dec[..., None] * x)), Bh)           # (b,H,nT,P,N)
    r_own = mm(T_(carry(ex[..., None] * y)), Ch)
    hs, h = [], torch.zeros(b, H, P, N, dtype=x.dtype)
    for c in range(nT):
        hs.append(h)
        h = torch.exp(last[:, :, c])[..., None, None] * h + s_own[:, :, c]
    gs, g = [], (dst.clone() if dst is not None
                 else torch.zeros(b, H, P, N, dtype=x.dtype))
    for c in reversed(range(nT)):
        gs.append(g)
        g = torch.exp(last[:, :, c])[..., None, None] * g + r_own[:, :, c]
    h_in, g = torch.stack(hs, 2), torch.stack(gs[::-1], 2)  # (b,H,nT,P,N)
    L = torch.exp(_segsum(da_t))          # e^{a_t - a_s}, s <= t
    dxm = mm(y, T_(x))
    W = L * mm(Ch, T_(Bh))
    V = L * dxm
    Mm = W * dxm
    u = mm(Bh, T_(carry(g)))                                # (..,T,P)
    w = dec * (x * u).sum(-1)
    dx = dec[..., None] * u + mm(T_(carry(W)), y)
    dBh = dec[..., None] * mm(x, carry(g)) + mm(T_(carry(V)), Ch)
    dyh = ex[..., None] * mm(y, carry(h_in))
    dCh = dyh + mm(carry(V), Bh)
    da = Mm.sum(-1) - Mm.sum(-2) + (Ch * dyh).sum(-1) - w
    da[..., -1] += torch.exp(last) * (g * h_in).sum((-1, -2)) + w.sum(-1)
    ddA = da.flip(-1).cumsum(-1).flip(-1)
    cut = lambda t: t.reshape(b, H, nT * T, -1)[:, :, :S]
    group = lambda t: cut(t).reshape(b, G, rep, S, N).sum(2)
    return (cut(dx), ddA.reshape(b, H, nT * T)[:, :, :S], group(dBh),
            group(dCh))


def _ssd_bwd_3xtf32_design(xdt, dA, B, C, dy, dst, chunk, pad_to=None):
    """The float32 kernels' arithmetic: every product as three TF32
    products (``_tf32_product``) summed in float32."""
    return _ssd_bwd_design(xdt, dA, B, C, dy, dst, chunk,
                           mm=lambda a, b: _tf32_product(a, b, 3),
                           pad_to=pad_to)


def _ssd_bwd_bf16_design(xdt, dA, B, C, dy, dst, chunk, pad_to=None):
    """The bfloat16 kernels' arithmetic: bfloat16 inputs, products summed
    in float32, every operand formed in float32 (the decayed rows, W, V,
    h and g) as a bfloat16 pair; the gradients rounded to the inputs'
    type."""
    f = lambda t: None if t is None else t.float()
    got = _ssd_bwd_design(f(xdt), f(dA), f(B), f(C), f(dy), f(dst), chunk,
                          carry=_bf16_pair, pad_to=pad_to)
    return tuple(t.to(xdt.dtype) for t in got)


def _ssd_kernel_inputs(b=1, H=4, G=2, S=96, P=8, N=16, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    ins = (f(b, H, S, P) * 0.5,
           (-np.log1p(np.exp(f(b, H, S))) * 0.5).astype(np.float32),
           f(b, G, S, N) * 0.5, f(b, G, S, N) * 0.5)
    return ins, f(b, H, S, P), f(b, H, P, N)


def _plain_ssd_grads(ins, dy, dst, chunk):
    leaves = _leaves(*ins)
    y, st = ssd_chunked_folded(*leaves, chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if dst is not None:
        loss = loss + (st * torch.from_numpy(dst)).sum()
    loss.backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("S,P,N,chunk", [(96, 8, 16, 16), (128, 16, 8, 64),
                                         (192, 8, 8, 96)])
@pytest.mark.parametrize("with_dst", [True, False])
def test_ssd_backward_design_matches_autograd(S, P, N, chunk, with_dst):
    """Several tiles, G 2 < H 4, a ragged last tile at chunk 96 (tiles of
    64), with and without a final-state gradient."""
    ins, dy, dst = _ssd_kernel_inputs(S=S, P=P, N=N)
    dst = dst if with_dst else None
    got = _ssd_bwd_design(*(torch.from_numpy(t) for t in ins),
                          torch.from_numpy(dy),
                          None if dst is None else torch.from_numpy(dst),
                          chunk)
    for g, w in zip(got, _plain_ssd_grads(ins, dy, dst, chunk)):
        _close(g, w)


def _ssd_errors_from_f64(got, ins, dy, dst, chunk):
    """Each SSD gradient's largest error against the chunked plain
    version's autograd in float64, as a share of its largest magnitude:
    (kernel's, the plain version's in the inputs' dtype) by gradient."""
    def grads(*ts):
        leaves = [t.detach().clone().requires_grad_(True) for t in ts]
        y, st = ssd_chunked_folded(*leaves, chunk)
        outs, gs = [y], [dy.to(y.dtype)]
        if dst is not None:
            outs.append(st)
            gs.append(dst.to(st.dtype))
        return torch.autograd.grad(outs, leaves, gs)

    exact = grads(*(t.double() for t in ins))
    plain = grads(*ins)
    out = []
    for a, p, e in zip(got, plain, exact):
        scale = float(e.abs().max())
        out.append((float((a.double() - e).abs().max()) / scale,
                    float((p.double() - e).abs().max()) / scale))
    return out


# (H, G, S, P, N, chunk, pad_to): several tiles; a ragged last tile at
# chunk 96; P and N padded to the kernel's generic instance; mamba2's
# P 64, N 128 on its own instance
SSD_TC_CASES = [(4, 2, 192, 8, 16, 64, None), (4, 2, 192, 8, 8, 96, None),
                (4, 2, 96, 20, 24, 32, (64, 64)),
                (4, 1, 128, 64, 128, 64, None)]


@pytest.mark.parametrize("H,G,S,P,N,chunk,pad_to", SSD_TC_CASES)
@pytest.mark.parametrize("with_dst", [True, False])
def test_ssd_backward_3xtf32_design_within_twice_plain(H, G, S, P, N, chunk,
                                                       pad_to, with_dst):
    """The float32 tensor-core kernels' arithmetic (3xTF32 products, the
    chunk-parallel states), held as the card holds the kernels: each
    gradient at most twice as far from the plain version's float64
    gradients as the float32 plain version's."""
    ins, dy, dst = _ssd_kernel_inputs(H=H, G=G, S=S, P=P, N=N, seed=11)
    ins = tuple(torch.from_numpy(t) for t in ins)
    dy = torch.from_numpy(dy)
    dst = torch.from_numpy(dst) if with_dst else None
    got = _ssd_bwd_3xtf32_design(*ins, dy, dst, chunk, pad_to)
    for kernel, plain in _ssd_errors_from_f64(got, ins, dy, dst, chunk):
        assert kernel <= 2 * plain


@pytest.mark.parametrize("H,G,S,P,N,chunk,pad_to", SSD_TC_CASES)
@pytest.mark.parametrize("with_dst", [True, False])
def test_ssd_backward_bf16_design_within_twice_plain(H, G, S, P, N, chunk,
                                                     pad_to, with_dst):
    """The bfloat16 tensor-core kernels' arithmetic (bfloat16 inputs, the
    operands formed in float32 as bfloat16 pairs, float32 sums, gradients
    in bfloat16), each gradient at most twice as far from the plain
    version's float64 gradients as the bfloat16 plain version's."""
    ins, dy, dst = _ssd_kernel_inputs(H=H, G=G, S=S, P=P, N=N, seed=12)
    ins = tuple(torch.from_numpy(t).bfloat16() for t in ins)
    dy = torch.from_numpy(dy).bfloat16()
    dst = torch.from_numpy(dst) if with_dst else None
    got = _ssd_bwd_bf16_design(*ins, dy, dst, chunk, pad_to)
    for g in got:
        assert g.dtype == torch.bfloat16
    for kernel, plain in _ssd_errors_from_f64(got, ins, dy, dst, chunk):
        assert kernel <= 2 * plain


# ------------------------------- 3. the autograd.Functions, on emulations
@pytest.fixture
def emulated_flash(monkeypatch):
    """The flash wrapper's launches replaced by the CPU emulations, and its
    kernel branch taken for CPU tensors; records each launch."""
    calls = []

    def forward(q, k, v, causal, with_lse):
        calls.append(("forward", with_lse))
        out, lse = _flash_fwd_lse(q, k, v, causal)
        return out, lse if with_lse else None

    def backward(q, k, v, lse, dout, causal):
        calls.append(("backward", tuple(lse.shape)))
        return _flash_bwd_design(q, k, v, lse, dout, causal)

    monkeypatch.setattr(flash_ops, "_forward", forward)
    monkeypatch.setattr(flash_ops, "_backward", backward)
    monkeypatch.setattr(flash_ops, "use_kernel", lambda impl, t: True)
    return calls


def test_flash_function_wiring(emulated_flash):
    """Under grad the entry point goes through _FlashAttention: it saves q,
    k, v and the (B, H, Sq) log-sum-exp, and its backward's
    gradients (the GQA sum inside dK/dV) equal the plain version's; without
    grad it launches the forward alone, with no log-sum-exp."""
    B, H, Hkv, Sq, Sk, Dh = 2, 4, 2, 96, 96, 64
    q, k, v, do = _flash_inputs(B, H, Hkv, Sq, Sk, Dh, seed=4)
    leaves = _leaves(q, k, v)
    out = flash_ops.flash_attention(*leaves, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh), (B, H, Sq)]
    out.backward(torch.from_numpy(do))
    assert emulated_flash == [("forward", True), ("backward", (B, H, Sq))]
    for g, w in zip((t.grad for t in leaves),
                    _plain_flash_grads(q, k, v, do)):
        _close(g, w)
    with torch.no_grad():
        flash_ops.flash_attention(*leaves, causal=True)
    assert emulated_flash[-1] == ("forward", False)


def test_flash_function_only_grads_what_needs_it(emulated_flash):
    """k and v alone require grad: q's gradient stays None."""
    q, k, v, do = _flash_inputs(1, 2, 1, 64, 64, 32, seed=5)
    tq = torch.from_numpy(q)
    tk, tv = _leaves(k, v)
    flash_ops.flash_attention(tq, tk, tv).backward(torch.from_numpy(do))
    assert tq.grad is None
    want = _plain_flash_grads(q, k, v, do)
    _close(tk.grad, want[1])
    _close(tv.grad, want[2])


@pytest.fixture
def emulated_ssd(monkeypatch):
    """The SSD wrapper's launches replaced by the plain forward and the
    backward's emulation, and its kernel branch taken for CPU tensors."""
    calls = []

    def forward(xdt, dA, B, C, chunk):
        calls.append("forward")
        with torch.no_grad():
            return ssd_chunked_folded(xdt, dA, B, C, chunk)

    def backward(xdt, dA, B, C, dy, dst, chunk):
        calls.append(("backward", dy is None, dst is None))
        return _ssd_bwd_design(xdt, dA, B, C,
                               torch.zeros_like(xdt) if dy is None else dy,
                               dst, chunk)

    monkeypatch.setattr(ssd_ops, "_forward", forward)
    monkeypatch.setattr(ssd_ops, "_backward", backward)
    monkeypatch.setattr(ssd_ops, "use_kernel", lambda impl, t: True)
    return calls


def test_ssd_function_saves_inputs_only(emulated_ssd):
    """_SSDScan keeps xdt, dA, B and C and no chunk states; the gradient of
    y alone, of the final state alone, and of both, each equal the plain
    version's (dB and dC summed over each group's heads)."""
    ins, dy, dst = _ssd_kernel_inputs()
    for use_y, use_st in ((True, False), (False, True), (True, True)):
        leaves = _leaves(*ins)
        y, st = ssd_ops.ssd_scan_kernel(*leaves, chunk=32)
        assert type(y.grad_fn).__name__ == "_SSDScanBackward"
        assert [tuple(t.shape) for t in y.grad_fn.saved_tensors] == [
            t.shape for t in ins]
        loss = 0
        if use_y:
            loss = loss + (y * torch.from_numpy(dy)).sum()
        if use_st:
            loss = loss + (st * torch.from_numpy(dst)).sum()
        loss.backward()
        assert emulated_ssd[-1] == ("backward", not use_y, not use_st)
        want = _plain_ssd_grads(ins, dy if use_y else np.zeros_like(dy),
                                dst if use_st else None, 32)
        for t, w in zip(leaves, want):
            _close(t.grad, w)


def test_ssd_entry_point_gradients_through_function(emulated_ssd):
    """The model-layout entry point: x·dt and dt·A stay torch ops around
    _SSDScan, so x, dt, A, B and C get the plain version's gradients."""
    ins, dy, dst = _ssd_model_inputs(S=64)
    leaves = _leaves(*ins)
    y, st = ssd_ops.ssd_scan(*leaves, chunk=16)
    ((y * torch.from_numpy(dy)).sum()
     + (st * torch.from_numpy(dst)).sum()).backward()
    assert emulated_ssd == ["forward", ("backward", False, False)]
    plain = _leaves(*ins)
    y, st = ssm.ssd_chunked(*plain, chunk=16)
    ((y * torch.from_numpy(dy)).sum()
     + (st * torch.from_numpy(dst)).sum()).backward()
    for t, w in zip(leaves, plain):
        _close(t.grad, w.grad)


# ------------------------------- 4. a train step at 2048 tokens vs the reference
@pytest.mark.parametrize("route", ["plain", "function"])
def test_reduced_smollm_step_at_2048_matches_reference(route, request):
    """The reduced smollm-135m (4 layers, 4 heads of 16 over 2 KV heads) on
    the reference's own init, B 1 x 2048 tokens: the attention takes the
    flash branch in both packages.  The loss within 1e-5 and every
    gradient leaf within 1e-4 (test_torch_train's tolerances) of
    ``jax.value_and_grad`` of the reference's loss; ``function`` routes the
    port's attention through _FlashAttention on the emulated kernels."""
    if route == "function":
        request.getfixturevalue("emulated_flash")
    ref_cfg = ref_base.reduced(REF_ARCHS["smollm-135m"])
    cfg = base.reduced(get_arch("smollm-135m"))
    params = ref_model.init(ref_cfg, jax.random.key(0))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (1, 2049)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_r, grads_r = jax.value_and_grad(
        lambda p: ref_ts.loss_fn(ref_cfg, p, batch))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    named = dict(model.named_parameters())
    loss = loss_fn(model, tb)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert float(loss.detach()) == pytest.approx(float(loss_r), rel=1e-5)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(grads_r)[0]}
    got = {k: t.numpy() for k, t in M.stacked_leaves(cfg, grads)}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
