"""Core NN building blocks of the dense model: norms, RoPE, attention (GQA
and MLA) and the MLP, in PyTorch.

The functions take a block's parameters as attributes of ``p`` (a
:class:`~repro_torch.models.model.DenseBlock`), in the reference's
orientation: ``wq (d, h, hd)``, ``wk``/``wv (d, kv, hd)``, ``wo (h, hd,
d)``, ``w_up``/``w_gate (d, f)``, ``w_down (f, d)``; MLA's ``w_dkv (d,
lora + rope)``, ``w_uk``/``w_uv (lora, h, hd)``, and ``w_dq (d, q_lora)``
with ``w_uq (q_lora, h, qk)`` or ``wq (d, h, qk)``.  ``ParamDef`` schemas
describe every parameter (shape, logical axes, init kind and scale) as in
the reference, so a model built here and one built there line up name for
name.

Conventions:
  activations  (B, S, D)  — batch, sequence, d_model
  GQA caches   (B, Hkv, S, Dh)
  MLA caches   (B, S, kv_lora + rope_dim)   (compressed latent, per layer)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.parallel.sharding import (NULL_CTX, ShardingCtx,
                                           SumOverGroup, is_dtensor,
                                           pad_shards)

# sequences at or above this length use the flash (online-softmax) attention
# path: O(S * block) memory instead of the O(S^2) score matrix
FLASH_MIN_SEQ = 2048

# --------------------------------------------------------------------------
# param schema
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple              # logical axis name per dim (None = unsharded)
    init: str = "normal"     # normal | zeros | ones
    scale: float = 0.02
    dtype: object = None     # None = container default; else pinned (e.g.
                             # f32 SSM states that must not decay in bf16)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def init_(t: torch.Tensor, d: ParamDef,
          generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place as ``d`` says: zeros, ones, or normals of
    standard deviation ``d.scale`` drawn from ``generator`` (which lives
    on ``t``'s device)."""
    if d.init == "zeros":
        return t.zero_()
    if d.init == "ones":
        return t.fill_(1.0)
    return t.normal_(0.0, d.scale, generator=generator)


def abstract_params(schema: dict, dtype: torch.dtype = torch.bfloat16
                    ) -> dict:
    """The schema's tree with each ``ParamDef`` as a tensor of its shape
    in ``dtype`` on the ``meta`` device: what the dry run sizes, with no
    storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return {k: abstract_params(d, dtype) if isinstance(d, dict)
            else torch.empty(d.shape, dtype=dtype, device="meta")
            for k, d in schema.items()}


# --------------------------------------------------------------------------
# norms / activations / rope
# --------------------------------------------------------------------------

class _MeanSquare(torch.autograd.Function):
    """The float32 mean of ``x``'s squares over its last dim (kept), with
    a backward that makes one float32 temporary of ``x``'s size and keeps
    ``x`` in its own dtype: autograd's makes four at once (the mean's
    expanded gradient, ``x ** 1``, its double and their product) and keeps
    the float32 copy.  The gradient is autograd's bit for bit: ``(g / n)
    · 2x``, rounded once."""

    @staticmethod
    def forward(fctx, x):
        fctx.save_for_backward(x)
        return x.float().square().mean(dim=-1, keepdim=True)

    @staticmethod
    def backward(fctx, g):
        (x,) = fctx.saved_tensors
        gx = x.to(torch.float32, copy=True).mul_(2).mul_(g / x.shape[-1])
        return gx.to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """The reference's rounding: ``rsqrt(var + eps)`` goes to x's dtype
    before the multiply."""
    var = _MeanSquare.apply(x)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def act_fn(name: str) -> Callable:
    if name == "gelu":   # jax.nn.gelu's default is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (nemotron-4)
        return lambda x: torch.relu(x).square()
    if name in ("silu", "silu_glu"):
        return F.silu
    raise ValueError(name)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """(S,) positions -> cos/sin of shape (S, head_dim // 2), float32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, Dh); cos/sin: (S, Dh//2). Rotate-half convention."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA)
# --------------------------------------------------------------------------

def gqa_schema(cfg: ModelConfig, layers: int) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    L = (layers,)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "wq": ParamDef(L + (d, h, hd), ("layers", "embed", "heads", None)),
        "wk": ParamDef(L + (d, kv, hd), ("layers", "embed", "kv_heads", None)),
        "wv": ParamDef(L + (d, kv, hd), ("layers", "embed", "kv_heads", None)),
        "wo": ParamDef(L + (h, hd, d), ("layers", "heads", None, "embed"),
                       scale=out_scale),
    }


def _by_heads(fn, q, k, v, ctx: ShardingCtx):
    """``fn(q, k, v)`` -> (B, H, S, Dh), an attention of q (B, H, S, Dh)
    over k/v (B, Hkv, T, Dh), on each rank's batch and query heads
    (``kernel_map``: heads are independent, so each is computed exactly
    as on one device).  Where the KV heads divide the heads' mesh axes
    too, each rank holds its own KV heads; where only the query heads
    do, K and V are whole on each rank (their gradient partial over the
    heads' axes) and each rank's query heads meet the KV heads they map
    to under the GQA repeat (:func:`_own_kv`).  Where the query heads do
    not divide, every rank runs every head of its batch."""
    b = ctx.batch_entry(q.shape[0])
    H, Hkv = q.shape[1], k.shape[1]
    entry = ctx.head_entry(H, Hkv)
    qh = ctx.query_head_entry(H)
    if entry is not None or qh is None:
        spec = (b, entry)
        return ctx.kernel_map(fn, (spec, spec, spec), spec, q, k, v)
    lo, n, _ = ctx.local_range(qh, H)
    axes = ctx.spec_axes((qh,))
    return ctx.kernel_map(
        lambda q, k, v: fn(q, *_own_kv(k, v, lo, n, H // Hkv)),
        ((b, qh), (b,), (b,)), (b, qh), q, k, v, partial=((), axes, axes))


def _own_kv(k, v, lo: int, n: int, groups: int):
    """K and V cut to the KV heads that query heads ``lo`` .. ``lo + n -
    1`` meet (query head i meets KV head ``i // groups``): the one KV head
    where they share it, else each query head's own copy."""
    first, last = lo // groups, (lo + n - 1) // groups
    if first == last:
        return k[:, first:first + 1], v[:, first:first + 1]
    idx = torch.arange(lo, lo + n, device=k.device) // groups
    return k[:, idx], v[:, idx]


def _flash(q, k, v, impl: str, ctx: ShardingCtx):
    """The causal flash attention of q (B, H, S, Dh) over k/v (B, Hkv,
    S, Dh); under a mesh, on each rank's batch and heads
    (:func:`_by_heads`)."""
    fn = functools.partial(flash_attention, causal=True, impl=impl)
    if not is_dtensor(q):
        return fn(q, k, v)
    return _by_heads(fn, q, k, v, ctx)


def _softmax_attention(q, k, v, *, causal: bool,
                       cache_pos: Optional[int] = None):
    """The plain softmax attention of q (B, H, S, Dh) over k/v (B, Hkv, T,
    Dh), K and V repeated to the query heads: masked causally, or, with
    ``cache_pos``, past the write point of a decode step's cache."""
    groups = q.shape[1] // max(k.shape[1], 1)
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    S = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhsk,bhtk->bhst", q, k).float() * scale
    if cache_pos is not None:
        t = torch.arange(k.shape[2], device=q.device)
        qpos = cache_pos + torch.arange(S, device=q.device)
        scores = torch.where(t[None, :] <= qpos[:, None], scores, -1e30)
    elif causal:
        t = torch.arange(S, device=q.device)
        scores = torch.where(t[None, :] <= t[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtk->bhsk", probs, v)


def _attend(q, k, v, ctx: ShardingCtx, *, causal: bool):
    """:func:`_softmax_attention` without a cache.  On a mesh whose heads'
    axes the query heads divide, on each rank's batch and own query heads
    (:func:`_by_heads`): DTensor's own plan for the einsums flattens the
    split heads dim with the batch's (which some torch releases refuse,
    and others only at some shapes), and computes every query head on
    every rank where the KV heads do not divide.  Where the query heads
    do not divide, they are whole on every rank and DTensor's plan runs
    the einsums on each rank's batch."""
    fn = functools.partial(_softmax_attention, causal=causal)
    if is_dtensor(q) and ctx.query_head_entry(q.shape[1]) is not None:
        return _by_heads(fn, q, k, v, ctx)
    return fn(q, k, v)


def _proj(eq: str, x: torch.Tensor, w: torch.Tensor, ctx: ShardingCtx,
          dim: str = "h") -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` (batch first)
    and a weight ``w`` with a dim the rules may shard (``dim`` in ``eq``:
    the heads, or an SSM's inner dim).  On a mesh:

    * where that dim is unsharded (its size does not divide the axis),
      each rank runs the einsum on its own batch rows with the weight
      gathered whole, as the reference's GSPMD does: DTensor's own
      einsum may shard the flattened heads x head-dim product over the
      free axis and then cannot unflatten it;
    * where it is sharded and summed over (an output projection, to
      ``bsd``), each rank runs the einsum on its own batch rows and its
      own slice of that dim, and the partial sums are all-reduced: the
      output is placed as the residual stream is, whatever the torch
      release, and the backward gives each rank the gradient of its own
      slice only (DTensor's plan leaves a ``Partial`` output, and in its
      backward builds the gradient of every head on each rank before
      cutting out its own).  Without a gradient and with fewer token
      rows on a rank than ``d`` (a decode step), DTensor's plan, which
      moves those rows rather than gathering the weight, and its partial
      sums all-reduced at once;
    * where it is sharded and kept (an input projection), DTensor's plan.

    Each ``kernel_map`` gathers the weight over its other dims (FSDP's
    gather); its gradient is a partial sum over the batch axes."""
    if not is_dtensor(w):
        return torch.einsum(eq, x, w)
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    axes = [a for a, pl in zip(ctx.shape, w.placements)
            if pl.is_shard(ws.index(dim))]
    b = ctx.batch_entry(x.shape[0])
    if axes and dim in out:
        return torch.einsum(eq, x, w)
    if not axes:
        return ctx.kernel_map(functools.partial(torch.einsum, eq),
                              ((b,), ()), (b,), x, w,
                              partial=((), ctx.spec_axes((b,))))
    rows = x.shape[0] // ctx._axis_size(b or ()) * x.shape[xs.index("s")]
    if not torch.is_grad_enabled() and rows < w.shape[ws.index("d")]:
        return ctx.constrain(torch.einsum(eq, x, w),
                             "batch", "seq", "act_embed")
    entry = axes[0] if len(axes) == 1 else tuple(axes)
    groups = [ctx.group(a) for a in axes if ctx.shape[a] > 1]

    def local(x, w):
        y = torch.einsum(eq, x, w)
        for g in groups:
            y = SumOverGroup.apply(y, g)
        return y
    return ctx.kernel_map(
        local, (tuple(b if c == "b" else entry if c == dim else None
                      for c in xs),
                tuple(entry if c == dim else None for c in ws)),
        (b,), x, w, partial=((), ctx.spec_axes((b,))))


def gqa_attention(p, x: torch.Tensor, cos, sin, *, n_heads: int,
                  cache: Optional[tuple] = None, cache_pos: int = 0,
                  causal: bool = True,
                  kv_override: Optional[tuple] = None, impl: str = "auto",
                  ctx: ShardingCtx = NULL_CTX):
    """Grouped-query attention; returns (out, new_cache).

    With ``cache`` — ``(k, v)``, each (B, Hkv, S_max, Dh) — the new keys
    and values are written into it *in place* at ``cache_pos`` (index
    assignment where the reference uses ``dynamic_update_slice``), and the
    same two tensors come back as the new cache.  With ``kv_override`` —
    ``(src,)``, source embeddings (B, S_src, D) — this is cross-attention:
    K and V are projected from ``src``, neither Q nor K is rotated, and
    nothing is masked.  Without a cache or an override, a causal sequence
    of ``FLASH_MIN_SEQ`` or more tokens runs
    :func:`~repro_torch.kernels.flash_attention.ops.flash_attention`
    (``impl`` picks its kernel or plain version); every other call takes
    the plain softmax.

    With a cache and ``ctx.flash_decode`` on a mesh with a ``"model"``
    axis, decode runs :func:`flash_decode_gqa` over the sequence-sharded
    cache (the reference's condition).
    """
    B, S, D = x.shape
    if cache is not None and kv_override is None and ctx.flash_decode \
            and "model" in ctx.shape:
        return flash_decode_gqa(p, x, cache, cache_pos, n_heads=n_heads,
                                cos=cos, sin=sin, ctx=ctx)
    q = _proj("bsd,dhk->bhsk", x, p.wq, ctx)
    if kv_override is None:
        k = _proj("bsd,dhk->bhsk", x, p.wk, ctx)
        v = _proj("bsd,dhk->bhsk", x, p.wv, ctx)
        if cos is not None:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    else:
        src = kv_override[0]
        k = _proj("bsd,dhk->bhsk", src, p.wk, ctx)
        v = _proj("bsd,dhk->bhsk", src, p.wv, ctx)
        causal = False

    new_cache = None
    if cache is not None:
        ck, cv = cache
        write_cache(ck, k, cache_pos, 2)
        write_cache(cv, v, cache_pos, 2)
        k, v = ck, cv
        new_cache = (ck, cv)
        causal = False  # masking handled by length below

    if cache is None and causal and kv_override is None \
            and S >= FLASH_MIN_SEQ:
        # long-context prefill/train: O(S*block) online-softmax attention
        out = _flash(q, k, v, impl, ctx)
        return _proj("bhsk,hkd->bsd", out, p.wo, ctx), None

    if cache is not None:
        # decode: mask positions beyond the write point.  On a mesh the
        # sequence-sharded cache stays where it is and the step's query
        # heads (a few values) go whole to each rank, so that DTensor's
        # plan splits the scores by the cache's sequence, whatever the
        # heads do (a split heads dim it cannot flatten in torch 2.11)
        out = _softmax_attention(ctx.constrain(q, "batch"), k, v,
                                 causal=False, cache_pos=cache_pos)
    else:
        out = _attend(q, k, v, ctx, causal=causal)
    return _proj("bhsk,hkd->bsd", out, p.wo, ctx), new_cache


def write_cache(cache: torch.Tensor, new: torch.Tensor, pos: int,
                dim: int) -> None:
    """``cache[pos:pos + S]`` along ``dim`` = ``new`` (S rows), in place.

    For a DTensor cache sharded along ``dim`` (``cache_seq`` on the model
    axis), each rank writes the new rows that fall in its own slice, at
    their local offset: DTensor's slice assignment on a sharded dim would
    write each rank's shard at the global offset, the wrong rows."""
    from torch.distributed.tensor import Replicate
    S = new.shape[dim]
    pl = list(cache.placements) if is_dtensor(cache) else []
    sharded = [i for i, p in enumerate(pl) if p.is_shard(dim)]
    if not sharded:
        index = [slice(None)] * cache.ndim
        index[dim] = slice(pos, pos + S)
        cache[tuple(index)] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    rows = new.redistribute(mesh, [Replicate() if i in sharded else p
                                   for i, p in enumerate(pl)]).to_local()
    local = cache.to_local()
    coord, shard, shards = mesh.get_coordinate(), 0, 1
    for i in sharded:
        shard, shards = shard * mesh.size(i) + coord[i], shards * mesh.size(i)
    start = shard * -(-cache.shape[dim] // shards)   # torch.chunk's split
    lo = max(pos, start)
    hi = min(pos + S, start + local.shape[dim])
    if lo < hi:
        local.narrow(dim, lo - start, hi - lo).copy_(
            rows.narrow(dim, lo - pos, hi - lo).to(local.dtype))


def flash_decode_gqa(p, x: torch.Tensor, cache: tuple, cache_pos: int, *,
                     n_heads: int, cos, sin, ctx: ShardingCtx):
    """Decode attention over a KV cache sharded by sequence on the mesh's
    ``"model"`` axis (flash-decoding); returns (out, cache).

    Each rank computes a partial softmax over its slice of the cache,
    with the query heads grouped onto their KV heads (no repeat of K/V),
    and the combine is one max-reduction of the row maxima and two
    sum-reductions of the rescaled numerators and denominators over the
    model axis: O(B·H·Dh) bytes instead of gathering the cache.  The new
    token's K/V is written, in place, only on the rank whose slice holds
    ``cache_pos``.  ``cache`` is ``(k, v)``, each a DTensor (B, Hkv,
    S_max, Dh) placed by ``("batch", "cache_heads", "cache_seq")``."""
    from torch.distributed.tensor import DTensor
    B, S1, D = x.shape
    q = _proj("bsd,dhk->bhsk", x, p.wq, ctx)
    k_new = _proj("bsd,dhk->bhsk", x, p.wk, ctx)
    v_new = _proj("bsd,dhk->bhsk", x, p.wv, ctx)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    ck, cv = cache
    b = ctx.batch_entry(B)
    q_pl = ctx.placements_of((b,))
    kv_pl = ctx.placements_of((b, None, "model"))
    if list(ck.placements) != kv_pl or list(cv.placements) != kv_pl:
        raise ValueError(f"flash decode needs the cache placed as {kv_pl}, "
                         f"got {ck.placements}")
    write_cache(ck, k_new, cache_pos, 2)
    write_cache(cv, v_new, cache_pos, 2)
    q_ = q.redistribute(ctx.mesh, q_pl).to_local()
    ck_, cv_ = ck.to_local(), cv.to_local()
    group = ctx.group("model")
    i = dist.get_rank(group)
    S_loc = ck_.shape[2]
    Bl, H, _, Dh = q_.shape
    Hkv = ck_.shape[1]
    groups = H // max(Hkv, 1)
    # the q heads grouped onto their KV head: (B, Hkv, groups * S1, Dh)
    qg = q_.reshape(Bl, Hkv, groups * S1, Dh)
    s = torch.einsum("bhsk,bhtk->bhst", qg, ck_).float() / math.sqrt(Dh)
    t = i * S_loc + torch.arange(S_loc, device=s.device)
    s = torch.where(t <= cache_pos, s, -1e30)
    m = s.amax(dim=-1)                                     # (B, Hkv, g*S1)
    pr = torch.exp(s - m[..., None])
    den = pr.sum(dim=-1)
    num = torch.einsum("bhst,bhtk->bhsk", pr.to(cv_.dtype), cv_)
    M = m.clone()
    dist.all_reduce(M, dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - M)
    num = num * corr[..., None].to(num.dtype)
    den = den * corr
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    out = num / torch.clamp(den, min=1e-30)[..., None].to(num.dtype)
    out = out.reshape(Bl, H, S1, Dh).to(q_.dtype)
    out = DTensor.from_local(out, ctx.mesh, q_pl, run_check=False)
    return _proj("bhsk,hkd->bsd", out, p.wo, ctx), (ck, cv)


def cross_attention(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """Attention of ``x``'s queries to a frozen cross K/V cache ``k``,
    ``v`` (B, Hkv, S_src, Dh): no rope, no mask, the plain softmax (the
    reference's ``serve.decode._cross_from_cache``).  ``x`` is already
    normalised by the caller's cross-attention norm.  On a mesh, on each
    rank's batch and heads (:func:`_by_heads`), the cache read as its
    schema places it (DTensor's own plan for the einsums flattens a split
    heads dim, which torch 2.11 refuses)."""
    q = _proj("bsd,dhk->bhsk", x, p.wq, ctx)
    fn = functools.partial(_softmax_attention, causal=False)
    o = _by_heads(fn, q, k, v, ctx) if is_dtensor(q) else fn(q, k, v)
    return _proj("bhsk,hkd->bsd", o, p.wo, ctx)


# --------------------------------------------------------------------------
# attention (MLA — multi-head latent attention, deepseek-v2 / minicpm3)
# --------------------------------------------------------------------------

def mla_schema(cfg: ModelConfig, layers: int) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    L = (layers,)
    qdim = m.qk_nope_head_dim + m.qk_rope_head_dim
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    sch = {
        # KV compression: d -> latent (+ decoupled rope key)
        "w_dkv": ParamDef(L + (d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("layers", "embed", None)),
        # latent -> per-head K(nope) and V
        "w_uk": ParamDef(L + (m.kv_lora_rank, h, m.qk_nope_head_dim),
                         ("layers", None, "heads", None)),
        "w_uv": ParamDef(L + (m.kv_lora_rank, h, m.v_head_dim),
                         ("layers", None, "heads", None)),
        "wo": ParamDef(L + (h, m.v_head_dim, d),
                       ("layers", "heads", None, "embed"), scale=out_scale),
    }
    if m.q_lora_rank:
        sch["w_dq"] = ParamDef(L + (d, m.q_lora_rank),
                               ("layers", "embed", "lora"))
        sch["w_uq"] = ParamDef(L + (m.q_lora_rank, h, qdim),
                               ("layers", "lora", "heads", None))
    else:
        sch["wq"] = ParamDef(L + (d, h, qdim),
                             ("layers", "embed", "heads", None))
    return sch


def mla_attention(p, x: torch.Tensor, cos, sin, *, mla: MLAConfig,
                  cache: Optional[torch.Tensor] = None, cache_pos: int = 0,
                  causal: bool = True, impl: str = "auto",
                  ctx: ShardingCtx = NULL_CTX):
    """Multi-head latent attention; returns (out, new_cache).

    Scores are formed in the latent space (the *absorbed* form: ``q_nope
    W_uk`` against the latent, plus the rope parts), so decode reads only
    the compressed cache.  With ``cache`` — ``ckv`` (B, S_max, lora +
    rope) — this step's latent and rope key are written into it *in
    place* at ``cache_pos`` and the same tensor comes back as the new
    cache.  Without a cache, a causal sequence of ``FLASH_MIN_SEQ`` or
    more tokens takes the expanded form instead: per-head K from ``w_uk``
    and the broadcast rope key, V from ``w_uv`` padded to K's head dim,
    :func:`~repro_torch.kernels.flash_attention.ops.flash_attention`
    (``impl`` picks its kernel or plain version), and the output trimmed
    back to ``v_head_dim``.  ``cos``/``sin`` are the rope table of
    ``qk_rope_head_dim``."""
    B, S, D = x.shape
    nope, lora = mla.qk_nope_head_dim, mla.kv_lora_rank
    if getattr(p, "w_dq", None) is not None:
        q = _proj("bsr,rhk->bhsk", x @ p.w_dq, p.w_uq, ctx)
    else:
        q = _proj("bsd,dhk->bhsk", x, p.wq, ctx)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], cos, sin)

    ckv = x @ p.w_dkv                                   # (B, S, lora+rope)
    ckv = torch.cat([ckv[..., :lora], apply_rope(ckv[..., lora:], cos, sin)],
                    dim=-1)
    new_cache = None
    if cache is not None:
        write_cache(cache, ckv, cache_pos, 1)
        ckv = new_cache = cache
    c_lat, k_rope = ckv[..., :lora], ckv[..., lora:]

    if cache is None and causal and S >= FLASH_MIN_SEQ:
        # prefill: expand per-head K/V (naive MLA form) + flash attention
        k_nope = _proj("btr,rhk->bhtk", c_lat, p.w_uk, ctx)
        v = _proj("btr,rhk->bhtk", c_lat, p.w_uv, ctx)
        kr = k_rope[:, None].expand(-1, k_nope.shape[1], -1, -1)
        k_full = torch.cat([k_nope, kr], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # pad V to the K head dim for the shared kernel, trim after
        pad = q_full.shape[-1] - v.shape[-1]
        v_p = pad_shards(v, (0, pad)) if pad else v
        out = _flash(q_full, k_full, v_p, impl, ctx)
        out = out[..., :mla.v_head_dim]
        return _proj("bhsk,hkd->bsd", out, p.wo, ctx), None

    # absorbed: q' = q_nope @ W_uk -> latent space
    q_lat = _proj("bhsk,rhk->bhsr", q_nope, p.w_uk, ctx)
    scores = torch.einsum("bhsr,btr->bhst", q_lat, c_lat) \
        + torch.einsum("bhsk,btk->bhst", q_rope, k_rope)
    scores = scores.float() * (1.0 / math.sqrt(nope + mla.qk_rope_head_dim))
    t = torch.arange(ckv.shape[1], device=x.device)
    if cache is not None:
        qpos = cache_pos + torch.arange(S, device=x.device)
        scores = torch.where(t[None, :] <= qpos[:, None], scores, -1e30)
    elif causal:
        scores = torch.where(t[None, :] <= t[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    # out = probs @ (c_lat @ W_uv): absorb into latent, then lift per head
    lat = torch.einsum("bhst,btr->bhsr", probs, c_lat)
    out = _proj("bhsr,rhk->bhsk", lat, p.w_uv, ctx)
    return _proj("bhsk,hkd->bsd", out, p.wo, ctx), new_cache


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, layers: int, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    L = (layers,)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    sch = {
        "w_up": ParamDef(L + (d, f), ("layers", "embed", "mlp")),
        "w_down": ParamDef(L + (f, d), ("layers", "mlp", "embed"),
                           scale=out_scale),
    }
    if cfg.act == "silu_glu":
        sch["w_gate"] = ParamDef(L + (d, f), ("layers", "embed", "mlp"))
    return sch


def mlp(p, x: torch.Tensor, act: str,
        ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """The MLP, ``act(x @ w_up) @ w_down`` (the GLU form with ``w_gate``).

    On a mesh each rank runs it on its own tokens (``kernel_map``), with
    the weights gathered over their embed dim (FSDP's gather) and split
    over the ``"mlp"`` rule's axes as they are placed; the partial outputs
    are then summed over those axes, as the reference's GSPMD runs it.
    DTensor's own plan for the products may split the embed dim instead
    and make every rank compute activations of the global batch."""
    if not is_dtensor(p.w_up):
        return _mlp(x, p.w_up, p.w_down, p.w_gate, act=act)
    f_spec = ctx.spec_for(("mlp",), (p.w_up.shape[-1],))
    groups = [ctx.group(a) for a in ctx.spec_axes(f_spec)
              if ctx.shape[a] > 1]
    x_spec = (ctx.batch_entry(x.shape[0]),)
    ws, specs = [p.w_up, p.w_down], [(None, *f_spec), f_spec]
    if p.w_gate is not None:
        ws.append(p.w_gate)
        specs.append((None, *f_spec))

    def local(x, w_up, w_down, w_gate=None):
        y = _mlp(x, w_up, w_down, w_gate, act=act)
        for g in groups:
            y = SumOverGroup.apply(y, g)
        return y

    # x's gradient is partial over the mlp axes, the weights' over the
    # token axes
    partial = (ctx.spec_axes(f_spec), *[ctx.spec_axes(x_spec)] * len(ws))
    return ctx.kernel_map(local, (x_spec, *specs), x_spec, x, *ws,
                          partial=partial)


def _mlp(x, w_up, w_down, w_gate=None, *, act: str) -> torch.Tensor:
    h = x @ w_up
    if w_gate is not None:
        h = h * act_fn(act)(x @ w_gate)
    else:
        h = act_fn(act)(h)
    return h @ w_down
