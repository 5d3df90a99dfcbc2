"""Mixture-of-Experts FFN: top-k routing and sorted grouped dispatch, with
all experts on one device.

    moe_schema(cfg, layers)    -> the leaves of a MoE layer (ParamDef)
    route(logits, top_k)       -> (probs (T, k), ids (T, k))
    moe_ffn_local(p, x, cfg)   -> (B, S, D)

The reference computes the grouped expert product with
``jax.lax.ragged_dot`` over the tokens sorted by expert.  Here each expert
with tokens multiplies its contiguous slice of the sorted rows with
``torch.matmul``; experts that received no token are skipped.  Finding
the slices needs the group sizes on the host: one device-to-host read per
MoE layer (:func:`_host_offsets`), the only synchronisation of the layer.
The reference's expert-parallel bodies (``moe_ffn_ep``, ``moe_ffn_a2a``)
run inside ``shard_map`` across devices and are not ported: on one device
the reference itself takes ``moe_ffn_local``.

The functions take a layer's parameters as attributes of ``p`` (a
:class:`~repro_torch.models.model.DenseBlock`), named and oriented as the
reference's leaves: ``router (d, E)``, ``w_up``/``w_gate (E, d, fe)``,
``w_down (E, fe, d)``, and, with shared experts, ``shared_up``/
``shared_gate (d, n_shared * fe)``, ``shared_down (n_shared * fe, d)``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, act_fn


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


def _sort_by_expert(xf: torch.Tensor, ids: torch.Tensor, n_experts: int):
    """The (T, k) choices flattened and stably sorted by expert: (the rows
    of ``xf`` in that order (T*k, D), the sort order, each expert's first
    row in the sorted order (E + 1,), on the device)."""
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = xf[order // ids.shape[1]]              # token of each choice
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
    return torch.cat(out)


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
        f = act_fn(cfg.act)
        h = xf @ p.shared_up
        h = h * f(xf @ p.shared_gate) if p.shared_gate is not None else f(h)
        y = y + h @ p.shared_down
    return y.reshape(B, S, D)
