"""Mamba2 — state-space duality (SSD) blocks in PyTorch.

The SSD "chunked dual" form of arXiv:2405.21060: the sequence is split
into chunks; within a chunk a quadratic (attention-like) form runs, and
between chunks an O(S/Q) state recurrence carries the state.
:func:`ssd_chunked` is the plain version of that algorithm, the
reference package's own arithmetic; the model's prefill reaches it
through the ``ssd_scan`` entry point
(:mod:`repro_torch.kernels.ssd_scan.ops`), which runs the CUDA kernel on
a GPU and this function on the CPU.

Shapes (mamba2 conventions):
  x   (B, S, H, P)   heads x head_dim, H*P = expand * d_model
  dt  (B, S, H)      softplus-positive step sizes
  A   (H,)           negative decay rates (A = -exp(a_log))
  B,C (B, S, G, N)   input/output projections, G groups, N = d_state
State: (B, H, P, N), float32.

A block's parameters are attributes of ``p`` (a
:class:`~repro_torch.models.model.MambaBlock`) with the reference's names
and orientation.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_folded
from repro_torch.models.layers import ParamDef, _proj, rmsnorm
from repro_torch.parallel.sharding import NULL_CTX, ShardingCtx, is_dtensor


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def mamba2_schema(cfg: ModelConfig, layers: int) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    G, N = s.n_groups, s.d_state
    L = (layers,)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    # fused in_proj: [z, x, B, C, dt]
    proj = 2 * d_in + 2 * G * N + H
    return {
        "in_proj": ParamDef(L + (d, proj), ("layers", "embed", "ssm_inner")),
        "conv_w": ParamDef(L + (s.d_conv, d_in + 2 * G * N),
                           ("layers", None, "ssm_inner")),
        "conv_b": ParamDef(L + (d_in + 2 * G * N,), ("layers", "ssm_inner"),
                           init="zeros"),
        "a_log": ParamDef(L + (H,), ("layers", "heads"), init="ones"),
        "dt_bias": ParamDef(L + (H,), ("layers", "heads"), init="zeros"),
        "d_skip": ParamDef(L + (H,), ("layers", "heads"), init="ones"),
        "norm_w": ParamDef(L + (d_in,), ("layers", "ssm_inner"), init="ones"),
        "out_proj": ParamDef(L + (d_in, d), ("layers", "ssm_inner", "embed"),
                             scale=out_scale),
    }


# --------------------------------------------------------------------------
# SSD core (chunked scan) — the plain version
# --------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD forward in the model's layout.  Returns (y (B, S, H, P) in x's
    dtype, final_state (B, H, P, N) float32).

    Discretisation: dA = dt * A;  dB = dt * B (ZOH-simplified, as mamba2).
    ``dt`` is folded into ``x`` first (``xdt = x * dt``, rounded to x's
    dtype as the reference's ``ssd_scan`` entry point rounds it), then
    :func:`ssd_chunked_folded` runs on the kernel's layout (``ValueError``
    when ``chunk`` does not divide S)."""
    xdt = x * dt[..., None]
    dA = dt * A
    y, final = ssd_chunked_folded(
        xdt.transpose(1, 2), dA.transpose(1, 2), B.transpose(1, 2),
        C.transpose(1, 2), chunk, init_state)
    return y.transpose(1, 2), final


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token recurrence: state' = state * exp(dt * A) + dt * x (x) B;
    y = C . state' (the skip is added by the caller).  state (B, H, P, N)
    float32, x (B, H, P), dt (B, H), B/C (B, G, N)."""
    H, G = x.shape[1], B.shape[1]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=1) if rep > 1 else B     # (b, H, N)
    Ch = C.repeat_interleave(rep, dim=1) if rep > 1 else C
    dA = torch.exp(dt * A)                                     # (b, H)
    upd = (dt[..., None] * x)[..., :, None] * Bh[..., None, :]
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch.to(new_state.dtype), new_state)
    return y, new_state


# --------------------------------------------------------------------------
# full mamba2 block
# --------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    G, N = s.n_groups, s.d_state
    H = d_in // s.head_dim
    return torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H], dim=-1)


def _scan(xh, dt, A, Bg, Cg, chunk: int, impl: str, ctx: ShardingCtx):
    """``ssd_scan``; under a mesh, on each rank's batch and heads
    (``local_map``: each head's scan is independent, and a rank's heads
    meet their own groups when the groups divide the axis too, or the one
    group every head shares, whose gradient is then a partial sum over
    the heads' axes: each rank's heads give their part)."""
    fn = functools.partial(ssd_scan, chunk=chunk, impl=impl)
    if not is_dtensor(xh):
        return fn(xh, dt, A, Bg, Cg)
    b = ctx.batch_entry(xh.shape[0])
    G = Bg.shape[2]
    hd = ctx.head_entry(xh.shape[2], *((G,) if G > 1 else ()))
    g = hd if G > 1 else None
    heads = (b, None, hd)
    groups = (b, None, g)
    shared = () if g else ctx.spec_axes((hd,))
    return ctx.kernel_map(fn, (heads, heads, (hd,), groups, groups),
                          [heads, (b, hd)], xh, dt, A, Bg, Cg,
                          partial=((), (), (), shared, shared))


def _step(state, x, dt, A, Bg, Cg, ctx: ShardingCtx):
    """:func:`ssd_decode_step`; under a mesh, on each rank's batch and
    heads (``local_map``, as :func:`_scan`: DTensor's own plan for its
    einsum flattens a split heads dim, which torch 2.11 refuses)."""
    if not is_dtensor(x):
        return ssd_decode_step(state, x, dt, A, Bg, Cg)
    b = ctx.batch_entry(x.shape[0])
    G = Bg.shape[1]
    hd = ctx.head_entry(x.shape[1], *((G,) if G > 1 else ()))
    heads, groups = (b, hd), (b, hd if G > 1 else None)
    return ctx.kernel_map(ssd_decode_step,
                          (heads, heads, heads, (hd,), groups, groups),
                          [heads, heads], state, x, dt, A, Bg, Cg)


def _causal_conv(x, w, b):
    """The causal depthwise conv of x (B, S, C) with w (d_conv, C) and b
    (C,): a sum of d_conv shifted products over the zero-padded input (no
    F.conv1d: cuDNN would run float32 in TF32)."""
    S, K = x.shape[1], w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, k:k + S] * w[k] for k in range(K)) + b


def _conv(x, w, b, ctx: ShardingCtx):
    """:func:`_causal_conv`; under a mesh on each rank's own batch rows,
    split over the model axis too where they divide
    (:meth:`ShardingCtx.spread_entry`), with every channel (``kernel_map``:
    the weights gathered, their gradient a partial sum over the rows'
    axes).  DTensor's own pad fails in some torch releases, and its plan
    for the products differs between them (one splits the channels, and
    then gathers the output once for each of the three slices the layer
    takes of it)."""
    if not is_dtensor(x):
        return _causal_conv(x, w, b)
    spec = (ctx.spread_entry(x.shape[0]),)
    axes = ctx.spec_axes(spec)
    return ctx.kernel_map(_causal_conv, (spec, (), ()), spec, x, w, b,
                          partial=((), axes, axes))


def mamba2_block(p, h: torch.Tensor, cfg: ModelConfig, *,
                 conv_state: Optional[torch.Tensor] = None,
                 ssm_state: Optional[torch.Tensor] = None,
                 impl: str = "auto", ctx: ShardingCtx = NULL_CTX):
    """One mamba2 mixer.  Train/prefill: the conv as a sum over its window
    and the SSD through the ``ssd_scan`` entry point (``impl`` picks its
    kernel or plain version); decode (with ``conv_state`` (B, d_conv-1, C)
    and ``ssm_state`` (B, H, P, N)): one step from the cached conv tail and
    state.  Returns (out, (new_conv_state, new_ssm_state)); the prefill's
    new conv state is None, as in the reference."""
    s = cfg.ssm
    B_, S, D = h.shape
    d_in = s.expand * D
    G, N = s.n_groups, s.d_state
    H = d_in // s.head_dim

    zxbcdt = h @ p.in_proj
    z, xi, Bf, Cf, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.a_log.float())

    conv_in = torch.cat([xi, Bf, Cf], dim=-1)            # (B, S, conv_ch)
    new_conv_state = None
    if conv_state is not None:
        # decode: the cached last (d_conv - 1) inputs, then this one
        window = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
        new_conv_state = window[:, -(s.d_conv - 1):]
        conv = torch.einsum("bwc,wc->bc", window[:, -s.d_conv:], p.conv_w) \
            + p.conv_b
        conv = conv[:, None, :]
    else:
        conv = _conv(conv_in, p.conv_w, p.conv_b, ctx)
    conv = F.silu(conv)
    xi = conv[..., :d_in]
    Bf = conv[..., d_in:d_in + G * N]
    Cf = conv[..., d_in + G * N:]

    xh = xi.reshape(B_, -1, H, s.head_dim)
    Bg = Bf.reshape(B_, -1, G, N)
    Cg = Cf.reshape(B_, -1, G, N)

    if ssm_state is not None:
        y, new_ssm_state = _step(ssm_state.float(), xh[:, 0], dt[:, 0], A,
                                 Bg[:, 0], Cg[:, 0], ctx)
        y = y[:, None].to(h.dtype)
        new_ssm_state = new_ssm_state.to(ssm_state.dtype)
    else:
        y, new_ssm_state = _scan(xh, dt, A, Bg, Cg, min(s.chunk, S), impl,
                                 ctx)
    y = y + xh * p.d_skip[None, None, :, None].to(y.dtype)
    y = y.reshape(B_, -1, d_in)
    y = rmsnorm(y * F.silu(z), p.norm_w)
    out = _proj("bsi,id->bsd", y, p.out_proj, ctx, dim="i").to(h.dtype)
    return out, (new_conv_state, new_ssm_state)
