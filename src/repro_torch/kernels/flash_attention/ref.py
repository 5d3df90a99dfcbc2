"""Flash attention — plain PyTorch version (online softmax, double-chunked).

The oracle of the CUDA kernel in ``flash_attention.cu`` and the CPU path
of :mod:`repro_torch.kernels.flash_attention.ops`.  It follows the
reference package's blocked algorithm step for step: queries in blocks of
``q_block``, keys in blocks of ``kv_block``, both padded to whole blocks,
a running max ``m``, denominator ``l`` and accumulator ``acc`` in float32
(float64 for float64 inputs: the yardstick of the kernel's accuracy), and
the finite mask value ``NEG_INF``.  Memory is O(S * block) instead of
the O(S^2) score matrix, under autograd too: each query block is
recomputed in the backward (``torch.utils.checkpoint``), as the
reference checkpoints its ``q_step``.  The padded, repeated and cast K
and V reach each block's checkpoint as its inputs, not through the
closure, so that an enclosing checkpoint drops them with every other
saved tensor and recomputes them in the backward.  Without a graph to
keep (``no_grad``, a prefill), each block of q, K and V is padded,
repeated and cast where it is used and each output block is cast back
before the blocks are joined: no full-width working-dtype copy exists,
and the values are the same bit for bit.

Contract (shared with the kernel and ``ops.py``):
  q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh), GQA via H % Hkv == 0;
  causal masking aligns the *ends* of q and k (query i attends to keys
  j <= i + (Sk - Sq)).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dtype = q.dtype
    work = torch.float64 if dtype == torch.float64 else torch.float32
    groups = H // Hkv
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    nq = -(-Sq // q_block)
    nk = -(-Sk // kv_block)
    offset = Sk - Sq  # causal alignment
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device

    def q_step(qc, kv_at, qpos, n_blocks: int):
        """The output of one block of queries over the first ``n_blocks``
        key blocks that ``kv_at(kj)`` gives."""
        acc = torch.zeros_like(qc)
        m = torch.full(qc.shape[:3], NEG_INF, dtype=work, device=dev)
        l = torch.zeros(qc.shape[:3], dtype=work, device=dev)
        for kj in range(n_blocks):
            kc, vc = kv_at(kj)
            s = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * scale
            kpos = kj * kv_block + torch.arange(kv_block, device=dev)
            mask = kpos[None, :] < Sk                   # key padding
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

    def n_blocks_of(qi: int) -> int:
        # causal, with every query of the block seeing key 0: a key block
        # past the block's last query is masked whole and would leave m,
        # l and acc exactly as they are (p = 0, corr = 1), so it is not
        # visited; a query that sees no key keeps the visited-block
        # convention, every block visited
        first = qi * q_block + offset
        if causal and first >= 0:
            return min(nk, (first + q_block - 1) // kv_block + 1)
        return nk

    def qpos_of(qi: int) -> torch.Tensor:
        return qi * q_block + offset + torch.arange(q_block, device=dev)

    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if not keep:
        # no graph: each block of q, K and V is cut, padded, repeated and
        # cast where it is used, and each output block goes back to the
        # input dtype, so that no full-width working-dtype copy of q, K,
        # V or the output exists; casts, pads and repeats are exact, so
        # the values are those of the whole casts below
        def cut(t, i: int, size: int, rep: int = 1):
            c = t[:, :, i * size:(i + 1) * size]
            if rep > 1:
                c = c.repeat_interleave(rep, dim=1)
            return F.pad(c, (0, 0, 0, size - c.shape[2])).to(work)

        def kv_at(kj):
            return (cut(k, kj, kv_block, groups),
                    cut(v, kj, kv_block, groups))
        blocks = []
        for qi in range(nq):
            o = q_step(cut(q, qi, q_block), kv_at, qpos_of(qi),
                       n_blocks_of(qi))
            blocks.append(o[:, :, :Sq - qi * q_block].to(dtype))
        return torch.cat(blocks, dim=2)

    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    # pad to block multiples
    q = F.pad(q, (0, 0, 0, nq * q_block - Sq)).to(work)
    k = F.pad(k, (0, 0, 0, nk * kv_block - Sk)).to(work)
    v = F.pad(v, (0, 0, 0, nk * kv_block - Sk)).to(work)

    def step(qc, k, v, qpos, n_blocks: int):
        return q_step(qc, lambda kj: (k[:, :, kj * kv_block:
                                          (kj + 1) * kv_block],
                                      v[:, :, kj * kv_block:
                                          (kj + 1) * kv_block]),
                      qpos, n_blocks)

    # under autograd each query block is recomputed in the backward rather
    # than kept (the reference's jax.checkpoint of its q_step): the blocks'
    # (q_block, kv_block) scores would otherwise be kept for every layer.
    # k and v go in as the checkpoint's arguments, not through q_step's
    # closure: a checkpoint saves its arguments through the saved-tensor
    # hooks, so an enclosing checkpoint (a model block's) drops them and
    # recomputes them, where a closure keeps every layer's full-width
    # float32 copies alive until its backward.  Cast and repeat stay
    # above, once: per block, the K/V gradients would sum in another order
    blocks = [checkpoint(step, q[:, :, qi * q_block:(qi + 1) * q_block],
                         k, v, qpos_of(qi), n_blocks_of(qi),
                         use_reentrant=False)
              for qi in range(nq)]
    return torch.cat(blocks, dim=2)[:, :, :Sq].to(dtype)
