"""The SSD scan's plain versions, in the kernel's (B, H, S, ...) layout.

:func:`ssd_chunked_folded` is the chunked algorithm, the reference
model's own arithmetic: the kernel's plain version, which the entry point
(``ops.py``) runs on the CPU and ``models/ssm.py``'s ``ssd_chunked`` runs
after folding dt in.  :func:`ssd_chunk_parallel` is the same algorithm
in the three stages the CUDA kernel runs (chunk states, state passing,
chunk outputs), returning each stage's result for the card tests; only
tests call it.  :func:`ssd_scan_ref` is the oracle all of them and the
CUDA kernel (``ssd_scan.cu``) are held to, the exact recurrence

  state_s = exp(dA_s) * state_{s-1} + xdt_s (x) B_s     (P x N outer product)
  y_s     = C_s . state_s

one step per token, O(S) steps, with the state in float32 and y cast to
xdt's dtype, as the reference package's ``_direct`` computes it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def ssd_scan_ref(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int | None = None):
    """xdt (B, H, S, P) x pre-multiplied by dt, dA (B, H, S) = dt * A
    (negative decays), B/C (B, G, S, N) -> y (B, H, S, P) in xdt's dtype,
    final state (B, H, P, N) float32.  ``chunk`` is accepted for the
    kernel's signature and does not change the result."""
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=1) if rep > 1 else B   # (b, H, S, N)
    Ch = C.repeat_interleave(rep, dim=1) if rep > 1 else C
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for s in range(S):
        state = state * torch.exp(dA[:, :, s])[..., None, None] \
            + torch.einsum("bhp,bhn->bhpn", xdt[:, :, s], Bh[:, :, s])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, :, s].float(), state))
    y = torch.stack(ys, dim=2) if ys else xdt.new_zeros(xdt.shape)
    return y.to(xdt.dtype), state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) with out[..., i, j] = sum_{j < k <= i} x_k,
    -inf above the diagonal (lower-triangular cumulative sums)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked_folded(xdt, dA, B, C, chunk: int,
                       init_state: Optional[torch.Tensor] = None):
    """The chunked SSD on the kernel's layout: xdt (B, H, S, P), dA
    (B, H, S), B/C (B, G, S, N) -> y (B, H, S, P) in xdt's dtype, final
    state (B, H, P, N) float32.  All arithmetic is float32 (float64, and a
    float64 final state, for float64 inputs: the yardstick of the
    kernels' accuracy).

    Every product is between two operands (the reference's three- and
    four-operand einsums, taken left to right, would build a
    (b, H, c, Q, Q, P) intermediate); heads reach their group's B and C by
    broadcasting, not by repeating them."""
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc, Q, rep = S // chunk, chunk, H // G
    work = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    x = xdt.to(work).reshape(b, G, rep, nc, Q, P)
    a = dA.to(work).reshape(b, G, rep, nc, Q)
    Bc = B.to(work).reshape(b, G, 1, nc, Q, N)
    Cc = C.to(work).reshape(b, G, 1, nc, Q, N)
    cs = torch.cumsum(a, dim=-1)                         # within each chunk

    # 1) intra-chunk (quadratic) term: (C B^T o L) xdt
    L = torch.exp(_segsum(a))                            # (b,G,rep,nc,Q,Q)
    scores = Cc @ Bc.transpose(-1, -2)                   # (b,G,1,nc,Q,Q)
    y = (scores * L) @ x                                 # (b,G,rep,nc,Q,P)

    # 2) chunk states: each chunk's contribution to its final state
    decay = torch.exp(cs[..., -1:] - cs)                 # (b,G,rep,nc,Q)
    states = (x * decay[..., None]).transpose(-1, -2) @ Bc   # (..,nc,P,N)

    # 3) inter-chunk recurrence over the chunk-final states
    chunk_decay = torch.exp(cs[..., -1])                 # (b,G,rep,nc)
    if init_state is None:
        st = x.new_zeros((b, G, rep, P, N))
    else:
        st = init_state.to(work).reshape(b, G, rep, P, N)
    prev = []
    for c in range(nc):
        prev.append(st)                                  # state BEFORE c
        st = st * chunk_decay[..., c, None, None] + states[..., c, :, :]
    prev_states = torch.stack(prev, dim=3)               # (b,G,rep,nc,P,N)

    # 4) inter-chunk output term: the carry-in state read by each position
    y = y + (Cc @ prev_states.transpose(-1, -2)) * torch.exp(cs)[..., None]
    return y.reshape(b, H, S, P).to(xdt.dtype), st.reshape(b, H, P, N)


def ssd_chunk_parallel(xdt, dA, B, C, chunk: int):
    """The chunked SSD in the kernel's three stages, on the kernel's
    layout: xdt (B, H, S, P), dA (B, H, S), B/C (B, G, S, N) -> (y in
    xdt's dtype, final state (B, H, P, N) float32, stages).  All
    arithmetic is float32.

    The sequence is cut in tiles of ``chunk`` rows; a last tile that S
    does not fill is padded with zero rows and dA 0, which neither decay
    nor add to the state, as the kernel pads it.  ``stages`` holds, over
    the tiles c, ``decays`` (B, H, tiles) = exp(sum of the tile's dA),
    ``chunk_states`` (B, H, tiles, P, N), the state each tile builds from
    zero (stage 1), and ``passed_states`` (B, H, tiles, P, N), the state
    entering each tile (stage 2); stage 3 is y."""
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    nT, Q, rep = -(-S // chunk), chunk, H // G
    pad = nT * Q - S
    rows = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
    x = rows(xdt).reshape(b, G, rep, nT, Q, P)
    a = torch.nn.functional.pad(dA.float(), (0, pad)).reshape(b, G, rep, nT,
                                                               Q)
    Bc = rows(B).reshape(b, G, 1, nT, Q, N)
    Cc = rows(C).reshape(b, G, 1, nT, Q, N)
    cs = torch.cumsum(a, dim=-1)                          # within each tile

    # 1) chunk states: each tile's state from zero, and its decay
    decay = torch.exp(cs[..., -1:] - cs)                  # (b,G,rep,nT,Q)
    own = (x * decay[..., None]).transpose(-1, -2) @ Bc   # (..,nT,P,N)
    tile_decay = torch.exp(cs[..., -1])                   # (b,G,rep,nT)

    # 2) state passing: the state entering each tile
    st = x.new_zeros((b, G, rep, P, N))
    passed = []
    for c in range(nT):
        passed.append(st)
        st = st * tile_decay[..., c, None, None] + own[..., c, :, :]
    passed = torch.stack(passed, dim=3)                   # (..,nT,P,N)

    # 3) chunk outputs: (L o C B^T) xdt + exp(cs) o (C h_in^T)
    L = torch.exp(_segsum(a))                             # 0 above the diagonal
    y = ((Cc @ Bc.transpose(-1, -2)) * L) @ x
    y = y + (Cc @ passed.transpose(-1, -2)) * torch.exp(cs)[..., None]
    y = y.reshape(b, H, nT * Q, P)[:, :, :S]
    stages = {"decays": tile_decay.reshape(b, H, nT),
              "chunk_states": own.reshape(b, H, nT, P, N),
              "passed_states": passed.reshape(b, H, nT, P, N)}
    return y.to(xdt.dtype), st.reshape(b, H, P, N), stages
