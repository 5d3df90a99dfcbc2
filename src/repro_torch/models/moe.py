"""Mixture-of-Experts FFN: top-k routing, sorted grouped dispatch, and
the reference's two expert-parallel bodies.

    moe_schema(cfg, layers)          -> the leaves of a MoE layer (ParamDef)
    route(logits, top_k)             -> (probs (T, k), ids (T, k))
    moe_ffn(p, x, cfg, ctx)          -> (B, S, D), dispatched as below
    moe_ffn_local(p, x, cfg)         -> every expert on x's device
    moe_ffn_ep(p, x, cfg, group)     -> expert-parallel body (one all-reduce)
    moe_ffn_a2a(p, x, cfg, group)    -> all-to-all body (fixed capacity)

The reference computes the grouped expert product with
``jax.lax.ragged_dot`` over the tokens sorted by expert.  Here each expert
with tokens multiplies its contiguous slice of the sorted rows with
``torch.matmul``; experts that received no token are skipped.  Finding
the slices needs the group sizes on the host: one device-to-host read per
MoE layer (:func:`_host_offsets`), the only synchronisation of the layer.

:func:`moe_ffn` is the reference's dispatch (``_ffn_apply``): the local
path without a mesh, with ``moe_impl == "auto"``, on a model axis of 1 or
one that does not divide the experts; else the all-to-all body
(``"alltoall"``) or the expert-parallel one, each run on the local shards
of a model-axis group (``local_map``, the reference's ``shard_map``) with
the reference's per-weight specs.

The functions take a layer's parameters as attributes of ``p`` (a
:class:`~repro_torch.models.model.DenseBlock`, or a namespace of local
shards inside a body), named and oriented as the reference's leaves:
``router (d, E)``, ``w_up``/``w_gate (E, d, fe)``, ``w_down (E, fe, d)``,
and, with shared experts, ``shared_up``/``shared_gate (d, n_shared *
fe)``, ``shared_down (n_shared * fe, d)``.
"""
from __future__ import annotations

import math
import types

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, act_fn
from repro_torch.parallel.sharding import (NULL_CTX, ShardingCtx,
                                           SumOverGroup, is_dtensor)


def moe_schema(cfg: ModelConfig, layers: int) -> dict:
    """The reference's MoE leaves, in its order, stacked over ``layers``."""
    mo = cfg.moe
    d, fe = cfg.d_model, mo.d_ff_expert
    E = mo.n_experts
    L = (layers,)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    sch = {
        "router": ParamDef(L + (d, E), ("layers", "embed", None)),
        "w_up": ParamDef(L + (E, d, fe), ("layers", "experts", "embed", None)),
        "w_down": ParamDef(L + (E, fe, d),
                           ("layers", "experts", None, "embed"),
                           scale=out_scale),
    }
    if cfg.act == "silu_glu":
        sch["w_gate"] = ParamDef(L + (E, d, fe),
                                 ("layers", "experts", "embed", None))
    if mo.n_shared:
        fs = mo.n_shared * fe
        sch["shared_up"] = ParamDef(L + (d, fs), ("layers", "embed", "mlp"))
        sch["shared_down"] = ParamDef(L + (fs, d), ("layers", "mlp", "embed"),
                                      scale=out_scale)
        if cfg.act == "silu_glu":
            sch["shared_gate"] = ParamDef(L + (d, fs),
                                          ("layers", "embed", "mlp"))
    return sch


def route(logits: torch.Tensor, top_k: int):
    """softmax (in float32) -> top-k -> renormalise.  Returns (probs (T, k),
    ids (T, k)), each token's choices in descending order of probability."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p, top_i


def _sort_by_expert(xf: torch.Tensor, ids: torch.Tensor, n_experts: int,
                    routed: int | None = None):
    """The (T, k) choices flattened and stably sorted by expert: (the rows
    of ``xf`` in that order (T*k, D), the sort order, each expert's first
    row in the sorted order (E + 1,), on the device).

    Fake ids (a dry run traces without data:
    :mod:`repro_torch.launch.dryrun`) have no order: their offsets are
    then even shares of ``routed`` rows (by default all T*k), those
    balanced routing sends to the E experts, as a tensor on the host, so
    that the grouped product does the operations of the reference's
    ``ragged_dot`` over them."""
    from torch._subclasses.fake_tensor import (is_fake,
                                               unset_fake_temporarily)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = xf[order // ids.shape[1]]              # token of each choice
    if is_fake(ids):
        rows = flat_e.shape[0] if routed is None else routed
        with unset_fake_temporarily():
            offsets = torch.tensor([rows * e // n_experts
                                    for e in range(n_experts + 1)])
        return xs, order, offsets
    offsets = torch.searchsorted(
        flat_e[order], torch.arange(n_experts + 1, device=ids.device))
    return xs, order, offsets


def _host_offsets(offsets: torch.Tensor) -> list[int]:
    """The group offsets on the host: the layer's one device sync."""
    return offsets.tolist()


def _expert_mlp_sorted(xs: torch.Tensor, offsets: list[int], p,
                       act: str) -> torch.Tensor:
    """Each expert's MLP on its contiguous slice ``offsets[e] ..
    offsets[e + 1]`` of the sorted rows ``xs``; the reference's three
    ``ragged_dot`` products."""
    f = act_fn(act)
    out = []
    for e in range(len(offsets) - 1):
        lo, hi = offsets[e], offsets[e + 1]
        if lo == hi:
            continue
        x = xs[lo:hi]
        h = x @ p.w_up[e]
        h = h * f(x @ p.w_gate[e]) if p.w_gate is not None else f(h)
        out.append(h @ p.w_down[e])
    # a rank of an expert-parallel group may receive no choice at all
    return torch.cat(out) if out else xs.new_zeros((0, p.w_down.shape[-1]))


def moe_ffn_local(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The routed experts' weighted sum, plus the shared experts, of each
    token of ``x`` (B, S, D), with every expert on ``x``'s device."""
    mo = cfg.moe
    B, S, D = x.shape
    T, k = B * S, mo.top_k
    xf = x.reshape(T, D)
    probs, ids = route(xf @ p.router, k)
    xs, order, offsets = _sort_by_expert(xf, ids, mo.n_experts)
    ys_sorted = _expert_mlp_sorted(xs, _host_offsets(offsets), p, cfg.act)
    ys = torch.empty_like(ys_sorted)
    ys[order] = ys_sorted                       # back to (token, choice)
    y = (ys.reshape(T, k, D) * probs[..., None].to(ys.dtype)).sum(dim=1)

    if p.shared_up is not None:
        y = y + _shared_experts(p, xf, cfg.act)
    return y.reshape(B, S, D)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig,
            ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """The MoE FFN of a layer, dispatched as the reference's
    ``_ffn_apply``: :func:`moe_ffn_local` without a mesh, with
    ``moe_impl == "auto"``, on a model axis of 1 or one that does not
    divide ``n_experts`` (on a mesh, on each rank's tokens with every
    expert replicated); else :func:`moe_ffn_a2a` (``"alltoall"``) or
    :func:`moe_ffn_ep` on the model axis."""
    m = ctx.model_axis_size
    if ctx.mesh is None or ctx.moe_impl == "auto" or m == 1 \
            or cfg.moe.n_experts % m != 0:
        if not is_dtensor(x):
            return moe_ffn_local(p, x, cfg)
        return _moe_local_map(p, x, cfg, ctx)
    if ctx.moe_impl == "alltoall":
        return _moe_a2a_map(p, x, cfg, ctx)
    return _moe_ep_map(p, x, cfg, ctx)


# keys of the MoE FFN proper: only these enter a body (the block also
# carries attention weights and norms)
_MOE_KEYS = ("router", "w_up", "w_down", "w_gate",
             "shared_up", "shared_gate", "shared_down")


def _run_local(body, p, x, x_spec, w_specs: dict, partial: dict,
               ctx: ShardingCtx):
    """``body(namespace of local weights, local x)`` on each rank's
    shards (``local_map``): ``x`` placed by ``x_spec`` and each weight by
    ``w_specs``, the result placed as ``x``.  A weight replicated over a
    mesh axis that splits the tokens gets a partial gradient there, as do
    the inputs ``partial`` names (by ``"x"`` or weight) over its axes."""
    names = [k for k in _MOE_KEYS if getattr(p, k, None) is not None]
    x_axes = ctx.spec_axes(x_spec)

    def fn(x_local, *ws):
        local = dict.fromkeys(_MOE_KEYS)
        local.update(zip(names, ws))
        return body(types.SimpleNamespace(**local), x_local)

    return ctx.kernel_map(
        fn, (x_spec, *(w_specs[k] for k in names)), x_spec,
        x, *(getattr(p, k) for k in names),
        partial=(partial.get("x", ()),
                 *(tuple(a for a in (*x_axes, *partial.get(k, ()))
                         if a not in ctx.spec_axes(w_specs[k]))
                   for k in names)))


def _moe_local_map(p, x, cfg: ModelConfig, ctx: ShardingCtx):
    """:func:`moe_ffn_local` on each rank's tokens (batch-sharded, every
    expert replicated): the reference's local path under GSPMD."""
    x_spec = (ctx.batch_entry(x.shape[0]),)
    w_specs = {k: () for k in _MOE_KEYS}
    return _run_local(lambda pl, xl: moe_ffn_local(pl, xl, cfg), p, x,
                      x_spec, w_specs, {}, ctx)


def _moe_ep_map(p, x, cfg: ModelConfig, ctx: ShardingCtx):
    """:func:`moe_ffn_ep` on the model axis: the experts and the shared
    experts' hidden dim sharded over it, the router replicated, ``x``
    batch-sharded and replicated over the model axis (the reference's
    ``_moe_ep_shardmap``).  Each rank's gradients of ``x`` and of the
    router cover its own experts only: partial sums over the model
    axis."""
    w_specs = {"w_up": ("model",), "w_down": ("model",),
               "w_gate": ("model",), "shared_up": (None, "model"),
               "shared_gate": (None, "model"), "shared_down": ("model",),
               "router": ()}
    x_spec = (ctx.batch_axes() or None,)
    group = ctx.group("model")
    return _run_local(lambda pl, xl: moe_ffn_ep(pl, xl, cfg, group), p, x,
                      x_spec, w_specs,
                      {"x": ("model",), "router": ("model",)}, ctx)


def _moe_a2a_map(p, x, cfg: ModelConfig, ctx: ShardingCtx):
    """:func:`moe_ffn_a2a` on the model axis: the experts sharded over it,
    the router and shared experts replicated, ``x`` sharded over the
    batch axes and the model axis together when the batch divides their
    product, else over the batch axes and its sequence over the model
    axis (the reference's ``_moe_a2a_shardmap``)."""
    w_specs = {k: ("model",) if k in ("w_up", "w_down", "w_gate") else ()
               for k in _MOE_KEYS}
    ba = ctx.batch_axes()
    if x.shape[0] % (ctx._axis_size(ba) * ctx.model_axis_size) == 0:
        x_spec = ((*ba, "model"),)
    else:
        x_spec = (ba or None, "model")
    group = ctx.group("model")
    return _run_local(lambda pl, xl: moe_ffn_a2a(pl, xl, cfg, group), p, x,
                      x_spec, w_specs, {}, ctx)


def _shared_experts(p, xf: torch.Tensor, act: str) -> torch.Tensor:
    f = act_fn(act)
    h = xf @ p.shared_up
    h = h * f(xf @ p.shared_gate) if p.shared_gate is not None else f(h)
    return h @ p.shared_down


def moe_ffn_ep(p, x: torch.Tensor, cfg: ModelConfig, group) -> torch.Tensor:
    """The expert-parallel body, on one rank of the model-axis process
    ``group``: ``p`` holds the rank's expert slice (``w_up`` (E / n, d,
    fe), ...) and the shared experts' hidden slice, ``x`` (B, S, D) the
    rank's batch, the same on every rank of the group.  Every rank routes
    every token (the router is replicated) but computes only its own
    experts' choices: the others sort into a trailing trash group whose
    rows weigh nothing.  One all-reduce over ``group`` sums the routed and
    shared partial outputs."""
    mo = cfg.moe
    B, S, D = x.shape
    T, k = B * S, mo.top_k
    n_shards = dist.get_world_size(group)
    e_local = mo.n_experts // n_shards
    lo = dist.get_rank(group) * e_local
    xf = x.reshape(T, D)
    probs, ids = route(xf @ p.router, k)
    local = (ids >= lo) & (ids < lo + e_local)
    # non-local choices sort into the trash group (id e_local)
    e_l = torch.where(local, ids - lo, e_local)
    xs, order, offsets = _sort_by_expert(xf, e_l, e_local,
                                         T * k // n_shards)
    host = _host_offsets(offsets)
    ys_sorted = _expert_mlp_sorted(xs, host, p, cfg.act)
    # rows past the real groups (trash) stay zero
    ys = ys_sorted.new_zeros((T * k, D))
    ys[order[:host[-1]]] = ys_sorted
    w = probs * local
    y = (ys.reshape(T, k, D) * w[..., None].to(ys.dtype)).sum(dim=1)
    if p.shared_up is not None:                 # hidden dim sliced
        y = y + _shared_experts(p, xf, cfg.act)
    y = SumOverGroup.apply(y, group)
    return y.reshape(B, S, D)


def moe_ffn_a2a(p, x: torch.Tensor, cfg: ModelConfig, group
                ) -> torch.Tensor:
    """The all-to-all body (GShard-style, fixed capacity), on one rank of
    the model-axis process ``group`` with its own tokens ``x`` (B, S, D):
    route them, pack one buffer of ``cap`` slots per destination rank,
    exchange the buffers and their expert ids (two ``all_to_all_single``
    out), run the rank's experts, and send the results back (one in).

    ``cap = int(capacity_factor * T * k / n) or 1``; a choice's slot is
    its count among the earlier (token, choice) pairs bound for the same
    rank, and a choice at ``slot >= cap`` is dropped.  Dropped choices
    land on their rank's last slot, as the reference's scatter puts them:
    the last write wins, so when a rank overflows, its last slot holds a
    dropped (empty) choice and the choice kept there computes nothing
    either.  The shared experts run on the rank's own tokens."""
    from torch.distributed import _functional_collectives as funcol
    mo = cfg.moe
    B, S, D = x.shape
    T, k = B * S, mo.top_k
    n_shards = dist.get_world_size(group)
    e_local = mo.n_experts // n_shards
    cap = int(mo.capacity_factor * T * k / n_shards) or 1
    xf = x.reshape(T, D)
    probs, ids = route(xf @ p.router, k)
    flat_e = ids.reshape(-1)                             # (T*k,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    dest = flat_e // e_local
    one_hot = F.one_hot(dest, n_shards)
    slot = (one_hot.cumsum(0) - 1).gather(1, dest[:, None])[:, 0]
    keep = slot < cap
    slot = slot.clamp(max=cap - 1)
    cell = dest * cap + slot
    # the last write to each cell wins: a kept choice's cell is its own
    # unless a dropped choice of the same destination writes it later
    overflow = torch.zeros(n_shards, dtype=torch.bool, device=x.device)
    overflow[dest[~keep]] = True
    live = keep & ~(overflow[dest] & (slot == cap - 1))
    send = xf.new_zeros((n_shards * cap, D))
    send = send.index_put((cell[live],), xf[flat_t[live]])
    send_e = torch.full((n_shards * cap,), e_local, dtype=torch.long,
                        device=x.device)
    send_e[cell[live]] = (flat_e % e_local)[live]
    recv = funcol.all_to_all_single(send, None, None, group)
    recv_e = torch.empty_like(send_e)
    dist.all_to_all_single(recv_e, send_e, group=group)
    xs, order, offsets = _sort_by_expert(recv, recv_e[:, None], e_local,
                                         min(T * k, n_shards * cap))
    host = _host_offsets(offsets)
    ys_sorted = _expert_mlp_sorted(xs, host, p, cfg.act)
    ys = ys_sorted.new_zeros((n_shards * cap, D))      # trash rows zero
    ys[order[:host[-1]]] = ys_sorted
    back = funcol.all_to_all_single(ys, None, None, group)
    y_choice = back[cell] * live[:, None].to(back.dtype)
    y = (y_choice * probs.reshape(-1, 1).to(back.dtype)).reshape(
        T, k, D).sum(dim=1)
    if p.shared_up is not None:       # replicated: x is the rank's tokens
        y = y + _shared_experts(p, xf, cfg.act)
    return y.reshape(B, S, D)
