"""What the plain flash attention keeps alive under autograd, and that
it computes what it always did.

``flash_attention_ref`` pads, repeats (GQA) and casts K and V to its
working dtype once, then checkpoints each block of queries.  Those
full-width copies must reach each block's checkpoint as its inputs: a
checkpoint saves its inputs through the saved-tensor hooks, so an
enclosing checkpoint (a model block's, ``ShardingCtx.call_block``) drops
them and recomputes them in the backward, where copies read through the
closure would stay alive from every layer's forward to its backward.

The memory test records a weak reference to the storage of every tensor
an op makes during the forward (a ``TorchDispatchMode``) and asks, once
the forward has returned, which storages of the repeated K/V's size are
still alive besides the output's.  The bit-equality tests hold the output
and the gradients of q, k and v, in float32, bfloat16 and float64, with
and without an enclosing checkpoint, to a frozen copy of the arithmetic
the plain version had before its K and V became checkpoint inputs
(``_flash_ref_closure``): the change may move memory, never a bit.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_ref_memory.py
"""
import gc
import math
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, flash_attention_ref)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f64": torch.float64}


def _flash_ref_closure(q, k, v, *, causal=True, q_block=512,
                       kv_block=1024):
    """The plain version's arithmetic with ``q_step`` reading K and V
    from its closure: the oracle the bit-equality tests hold the port's
    plain version to (kept as it was; do not edit)."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dtype = q.dtype
    work = torch.float64 if dtype == torch.float64 else torch.float32
    groups = H // Hkv
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    pq = (-Sq) % q_block
    pk = (-Sk) % kv_block
    q = F.pad(q, (0, 0, 0, pq)).to(work)
    k = F.pad(k, (0, 0, 0, pk)).to(work)
    v = F.pad(v, (0, 0, 0, pk)).to(work)
    nq = q.shape[2] // q_block
    nk = k.shape[2] // kv_block
    offset = Sk - Sq
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device

    def q_step(qc, qpos, n_blocks: int):
        acc = torch.zeros_like(qc)
        m = torch.full(qc.shape[:3], NEG_INF, dtype=work, device=dev)
        l = torch.zeros(qc.shape[:3], dtype=work, device=dev)
        for kj in range(n_blocks):
            kc = k[:, :, kj * kv_block:(kj + 1) * kv_block]
            vc = v[:, :, kj * kv_block:(kj + 1) * kv_block]
            s = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * scale
            kpos = kj * kv_block + torch.arange(kv_block, device=dev)
            mask = kpos[None, :] < Sk
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                       p, vc)
            m = m_new
        return acc / torch.clamp(l, min=1e-30)[..., None]

    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    blocks = []
    for qi in range(nq):
        qc = q[:, :, qi * q_block:(qi + 1) * q_block]
        first = qi * q_block + offset
        qpos = first + torch.arange(q_block, device=dev)
        n_blocks = nk
        if causal and first >= 0:
            n_blocks = min(nk, (first + q_block - 1) // kv_block + 1)
        blocks.append(checkpoint(q_step, qc, qpos, n_blocks,
                                 use_reentrant=False)
                      if keep else q_step(qc, qpos, n_blocks))
    return torch.cat(blocks, dim=2)[:, :, :Sq].to(dtype)


@pytest.fixture
def one_thread():
    """Bit-equality on the CPU needs one thread: a threaded reduction may
    split its sums differently from call to call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, H, Hkv, Sq, Sk, Dh, dtype):
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        t = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
        return t.requires_grad_(True)
    return leaf(B, H, Sq, Dh), leaf(B, Hkv, Sk, Dh), leaf(B, Hkv, Sk, Dh)


class _Made(TorchDispatchMode):
    """Weak references to the storage of every tensor an op makes, with
    the storage's size in elements of the tensor's dtype."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.append((str(func), st.nbytes() // t.element_size(),
                                  weakref.ref(st)))
        return out


@pytest.mark.parametrize("dtype", ["bf16", "f32", "f64"])
def test_no_full_width_kv_copy_outlives_the_forward(dtype):
    """Under an enclosing checkpoint, once the forward has returned no
    storage of the repeated K/V's size that the plain version made is
    alive but the output's (float32 casts in bf16, the padded repeats in
    f32 and f64 stayed alive when ``q_step`` read K and V through its
    closure)."""
    B, H, Hkv, S, Dh = 1, 4, 2, 256, 16
    q, k, v = _qkv(0, B, H, Hkv, S, S, Dh, DTYPES[dtype])
    full = B * H * S * Dh
    with _Made() as mode:
        out = checkpoint(
            lambda q, k, v: flash_attention_ref(q, k, v, q_block=64),
            q, k, v, use_reentrant=False)
    gc.collect()
    # the output's storage and the inputs' (views of q, k, v) aside
    known = {id(t.untyped_storage()) for t in (out, q, k, v)}
    live, seen = [], set()
    for op, n, ref in mode.made:
        st = ref()
        if st is None or n < full or id(st) in known | seen:
            continue
        seen.add(id(st))
        live.append((op, n))
    assert live == [], f"alive after the forward: {live}"
    # and the backward, which recomputes them, still runs
    (g,) = torch.autograd.grad(out.float().sum(), (k,))
    assert g.shape == k.shape and torch.isfinite(g).all()


CASES = {
    # name: (B, H, Hkv, Sq, Sk, Dh, causal, q_block, kv_block)
    "gqa-causal": (2, 4, 2, 96, 96, 32, True, 16, 32),
    "mha-padded": (1, 2, 2, 70, 100, 16, True, 16, 32),
    "gqa-noncausal-padded": (1, 6, 2, 40, 50, 8, False, 16, 32),
}


@pytest.mark.parametrize("enclosed", [False, True],
                         ids=["bare", "checkpointed"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_flash_is_bit_equal_to_its_closure_form(case, dtype, enclosed,
                                                      one_thread):
    """Output and the gradients of q, k and v, bit for bit, against the
    closure form, bare and under an enclosing non-reentrant checkpoint."""
    B, H, Hkv, Sq, Sk, Dh, causal, qb, kb = CASES[case]
    q, k, v = _qkv(1, B, H, Hkv, Sq, Sk, Dh, DTYPES[dtype])
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, H, Sq, Dh))).to(DTYPES[dtype])

    def run(fn):
        def call(q, k, v):
            return fn(q, k, v, causal=causal, q_block=qb, kv_block=kb)
        out = (checkpoint(call, q, k, v, use_reentrant=False) if enclosed
               else call(q, k, v))
        grads = torch.autograd.grad((out * g).sum(), (q, k, v))
        return (out.detach(),) + grads

    got = run(flash_attention_ref)
    want = run(_flash_ref_closure)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_flash_without_grad_is_bit_equal(dtype, one_thread):
    """The path that keeps no graph (``q_step`` called directly)."""
    q, k, v = _qkv(3, 2, 4, 2, 96, 96, 32, DTYPES[dtype])
    with torch.no_grad():
        got = flash_attention_ref(q, k, v, q_block=16, kv_block=32)
        want = _flash_ref_closure(q, k, v, q_block=16, kv_block=32)
    assert torch.equal(got, want)


class _Alive(TorchDispatchMode):
    """After every op, the storages of ``dtype`` of at least ``n``
    elements that ops have made (or viewed) and that are still alive,
    each with the op that made it and its address; ``seen`` collects
    them."""

    def __init__(self, dtype, n):
        super().__init__()
        self.dtype, self.n = dtype, n
        self.made, self.seen = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == self.dtype:
                st = t.untyped_storage()
                if st.nbytes() // t.element_size() >= self.n:
                    self.made.append((str(func), weakref.ref(st)))
        for op, ref in self.made:
            st = ref()
            if st is not None and (op, st.data_ptr()) not in self.seen:
                self.seen.append((op, st.data_ptr()))
        return out


@pytest.mark.parametrize("case", ["even", "padded"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_no_grad_keeps_no_full_width_float32_copy(dtype, case, one_thread):
    """Without a graph, no float32 storage of K's size or more that the
    plain version makes is alive at any point of the call, the output's
    own aside: q, K and V are cast a block at a time and each output
    block goes back to the input dtype before the join.  The output is
    the closure form's bit for bit."""
    B, H, Hkv, Dh, qb, kb = 1, 4, 2, 32, 32, 64
    S = 256 if case == "even" else 250
    q, k, v = _qkv(4, B, H, Hkv, S, S, Dh, DTYPES[dtype])
    with torch.no_grad(), _Alive(torch.float32, B * Hkv * S * Dh) as mode:
        out = flash_attention_ref(q, k, v, q_block=qb, kv_block=kb)
    # the output's storage and the inputs' (views of q, k, v) aside
    known = {t.untyped_storage().data_ptr() for t in (out, q, k, v)}
    copies = [op for op, ptr in mode.seen if ptr not in known]
    assert copies == [], f"full-width float32 copies: {copies}"
    with torch.no_grad():
        want = _flash_ref_closure(q, k, v, q_block=qb, kv_block=kb)
    assert out.dtype == want.dtype and torch.equal(out, want)
