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
saved tensor and recomputes them in the backward.

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
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)

    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    # pad to block multiples
    pq = (-Sq) % q_block
    pk = (-Sk) % kv_block
    q = F.pad(q, (0, 0, 0, pq)).to(work)
    k = F.pad(k, (0, 0, 0, pk)).to(work)
    v = F.pad(v, (0, 0, 0, pk)).to(work)
    nq = q.shape[2] // q_block
    nk = k.shape[2] // kv_block
    offset = Sk - Sq  # causal alignment
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device

    def q_step(qc, k, v, qpos, n_blocks: int):
        """The output of one block of queries over its first ``n_blocks``
        key blocks of ``k`` and ``v``."""
        acc = torch.zeros_like(qc)
        m = torch.full(qc.shape[:3], NEG_INF, dtype=work, device=dev)
        l = torch.zeros(qc.shape[:3], dtype=work, device=dev)
        for kj in range(n_blocks):
            kc = k[:, :, kj * kv_block:(kj + 1) * kv_block]
            vc = v[:, :, kj * kv_block:(kj + 1) * kv_block]
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

    # under autograd each query block is recomputed in the backward rather
    # than kept (the reference's jax.checkpoint of its q_step): the blocks'
    # (q_block, kv_block) scores would otherwise be kept for every layer.
    # k and v go in as the checkpoint's arguments, not through q_step's
    # closure: a checkpoint saves its arguments through the saved-tensor
    # hooks, so an enclosing checkpoint (a model block's) drops them and
    # recomputes them, where a closure keeps every layer's full-width
    # float32 copies alive until its backward.  Cast and repeat stay
    # above, once: per block, the K/V gradients would sum in another order
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    blocks = []
    for qi in range(nq):
        qc = q[:, :, qi * q_block:(qi + 1) * q_block]
        first = qi * q_block + offset
        qpos = first + torch.arange(q_block, device=dev)
        # causal, with every query of the block seeing key 0: a key block
        # past the block's last query is masked whole and would leave m,
        # l and acc exactly as they are (p = 0, corr = 1), so it is not
        # visited; a query that sees no key keeps the visited-block
        # convention, every block visited
        n_blocks = nk
        if causal and first >= 0:
            n_blocks = min(nk, (first + q_block - 1) // kv_block + 1)
        blocks.append(checkpoint(q_step, qc, k, v, qpos, n_blocks,
                                 use_reentrant=False)
                      if keep else q_step(qc, k, v, qpos, n_blocks))
    return torch.cat(blocks, dim=2)[:, :, :Sq].to(dtype)
