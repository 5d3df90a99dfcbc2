"""The model stack as a PyTorch module.

    schema(cfg)                         -> nested dict of ParamDef (stacked)
    init(cfg, seed=..., device=...)     -> Transformer, parameters drawn
    Transformer(cfg, device=...)(tokens) -> logits  (train / prefill)

The reference scans one stacked parameter tree over its layers
(``lax.scan``); here each layer is a :class:`DenseBlock` or a
:class:`MambaBlock` in a ``ModuleList`` and the parameters of layer ``l``
are the slices ``[l]`` of the reference's stacked leaves, in the same
orientation, so loading one into the other is a slice per layer
(:func:`repro_torch.interop.model_params`).  :func:`param_leaves` names
that correspondence.

The port runs every family of the reference: the dense family with GQA
or MLA attention (smollm-135m, starcoder2-7b, nemotron-4-340b,
minicpm3-4b), the MoE family (phi3.5-moe-42b; deepseek-v2-lite-16b, whose
leading dense layers sit in ``dense0`` before the MoE ``blocks``), the SSM
family (mamba2-2.7b), the hybrid family (zamba2-7b: groups of mamba2
layers, each followed by one shared attention block, then trailing mamba2
layers), the VLM family (llama-3.2-vision-11b: groups of dense layers,
each followed by a :class:`CrossBlock` that attends to the vision
embeddings) and the encoder-decoder family (seamless-m4t-large-v2: a
stack of :class:`EncoderBlock` over the source frames, then one of
:class:`DecoderBlock` with causal self-attention and cross-attention to
the encoder's output).

``ctx`` (:class:`~repro_torch.parallel.sharding.ShardingCtx`) shards the
model over a device mesh, as the reference's does: with a mesh, the
parameters are DTensors (:meth:`ShardingCtx.distribute`), the activations
are constrained at the reference's points, each block runs under
activation checkpointing, the kernels run on each rank's heads through
``local_map``, and a MoE layer dispatches to the expert-parallel bodies
(:func:`~repro_torch.models.moe.moe_ffn`).  Without a mesh (``ctx=None``)
every helper is a no-op and the path is the one-device one.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models.layers import (ParamDef, cross_attention,
                                       gqa_attention, gqa_schema, init_,
                                       mla_attention, mla_schema, mlp,
                                       mlp_schema, rmsnorm, rope_freqs)
from repro_torch.models.moe import moe_ffn, moe_schema
from repro_torch.models.ssm import mamba2_block, mamba2_schema
from repro_torch.parallel.sharding import (NULL_CTX, ShardingCtx,
                                           is_dtensor, lookup_by_columns,
                                           lookup_by_rows, matmul_by_columns)

def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port cannot run yet."""
    if cfg.family != "ssm" and cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attn_type!r} is not ported yet; "
            f"ROADMAP.md queue 1 does not list it")


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def _norms_schema(cfg: ModelConfig, layers: int, n: int = 2) -> dict:
    return {f"ln{i+1}": ParamDef((layers, cfg.d_model),
                                 ("layers", "act_embed"), init="ones")
            for i in range(n)}


def _attn_schema(cfg: ModelConfig, layers: int) -> dict:
    if cfg.attn_type == "mla":
        return mla_schema(cfg, layers)
    return gqa_schema(cfg, layers)


def schema(cfg: ModelConfig) -> dict:
    """The reference's parameter schema of a model the port runs, with
    each group's leaves stacked over a leading layer axis: ``blocks`` (a
    dense or SSM model's layers; a MoE model's MoE layers; a hybrid
    model's G·k mamba2 layers; a VLM's G·k self-attention layers), for a
    MoE model with leading dense layers ``dense0`` (attention + an MLP of
    ``d_ff_first``) before ``blocks``, for a hybrid model ``trailing`` (its
    last n_layers − G·k mamba2 layers) and ``shared`` (its one attention +
    MLP block, stacked over 1), for a VLM ``cross`` (its G cross layers,
    with three norms of which the forward uses two, as the reference's),
    and for an encoder-decoder model ``encoder`` (``n_enc_layers``),
    ``enc_norm`` and ``decoder`` (``n_layers``, each with its ``self`` and
    ``cross`` attention leaves nested, the MLP and three norms)."""
    check_ported(cfg)
    d, V = cfg.d_model, cfg.vocab
    sch: dict = {
        "tok_emb": ParamDef((V, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), ("act_embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        sch["unembed"] = ParamDef((V, d), ("vocab", "embed"))
    L = cfg.n_layers
    if cfg.family == "ssm":
        sch["blocks"] = {**mamba2_schema(cfg, L),
                         **_norms_schema(cfg, L, n=1)}
    elif cfg.family == "hybrid":
        G, k, trail = _hybrid_split(cfg)
        sch["blocks"] = {**mamba2_schema(cfg, G * k),
                         **_norms_schema(cfg, G * k, n=1)}
        if trail:
            sch["trailing"] = {**mamba2_schema(cfg, trail),
                               **_norms_schema(cfg, trail, n=1)}
        # ONE shared attention block (true weight sharing, zamba2-style)
        sch["shared"] = {**_attn_schema(cfg, 1), **mlp_schema(cfg, 1),
                         **_norms_schema(cfg, 1)}
    elif cfg.family == "vlm":
        G, k = _vlm_split(cfg)
        sch["blocks"] = {**_attn_schema(cfg, G * k), **mlp_schema(cfg, G * k),
                         **_norms_schema(cfg, G * k)}
        sch["cross"] = {**_attn_schema(cfg, G), **mlp_schema(cfg, G),
                        **_norms_schema(cfg, G, n=3)}
    elif cfg.family == "encdec":
        Le, Ld = cfg.n_enc_layers, cfg.n_layers
        sch["encoder"] = {**_attn_schema(cfg, Le), **mlp_schema(cfg, Le),
                          **_norms_schema(cfg, Le)}
        sch["enc_norm"] = ParamDef((d,), ("act_embed",), init="ones")
        sch["decoder"] = {"self": _attn_schema(cfg, Ld),
                          "cross": _attn_schema(cfg, Ld),
                          **mlp_schema(cfg, Ld), **_norms_schema(cfg, Ld, n=3)}
    else:
        if cfg.family == "moe" and cfg.moe and cfg.moe.first_dense:
            Ld = cfg.moe.first_dense
            sch["dense0"] = {**_attn_schema(cfg, Ld),
                             **mlp_schema(cfg, Ld,
                                          d_ff=cfg.moe.d_ff_first or cfg.d_ff),
                             **_norms_schema(cfg, Ld)}
            L -= Ld
        ffn = (moe_schema(cfg, L) if cfg.family == "moe" and cfg.moe
               else mlp_schema(cfg, L))
        sch["blocks"] = {**_attn_schema(cfg, L), **ffn,
                         **_norms_schema(cfg, L)}
    return sch


def leaf_paths(tree: dict, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) of each leaf of a nested dict (a schema, or the
    reference's parameters), depth first in its order."""
    for key, d in tree.items():
        if isinstance(d, dict):
            yield from leaf_paths(d, prefix + (key,))
        else:
            yield prefix + (key,), d


def param_leaves(cfg: ModelConfig
                 ) -> Iterator[tuple[str, tuple, Optional[int], ParamDef]]:
    """Each parameter of a :class:`Transformer` as ``(module name, schema
    path, layer or None, ParamDef)``: ``("blocks.3.wq", ("blocks", "wq"),
    3, def)`` is slice 3 of the reference's stacked ``blocks/wq``, an
    encoder-decoder model's ``("decoder.3.self.wq", ("decoder", "self",
    "wq"), 3, def)`` slice 3 of ``decoder/self/wq``, and a hybrid model's
    ``("shared.wq", ("shared", "wq"), 0, def)`` the one slice of
    ``shared/wq``."""
    for path, d in leaf_paths(schema(cfg)):
        if len(path) == 1:
            yield path[0], path, None, d
        elif path[0] == "shared":
            yield ".".join(path), path, 0, d
        else:
            for layer in range(d.shape[0]):
                yield ".".join((path[0], str(layer)) + path[1:]), path, \
                    layer, d


def stacked_leaves(cfg: ModelConfig, by_name: Mapping[str, torch.Tensor]
                   ) -> Iterator[tuple[str, torch.Tensor]]:
    """The reference's leaves from tensors keyed by module name (the
    parameters, their gradients, AdamW's ``m`` or ``v``): ``("blocks/wq",
    the slices of every layer stacked over a leading axis)``, a hybrid
    model's ``shared`` stacked over 1, an unstacked leaf as it is.  The
    leaves come in the reference's order (``jax.tree.leaves``: sorted keys
    at every level), each stacked only when it is reached."""
    groups: dict = {}
    for name, path, layer, _ in param_leaves(cfg):
        groups.setdefault(path, []).append((name, layer))
    for path in sorted(groups):
        group = groups[path]
        name, layer = group[0]
        yield "/".join(path), (by_name[name] if layer is None else
                               torch.stack([by_name[n] for n, _ in group]))


def unstacked(cfg: ModelConfig, leaves: Mapping[str, torch.Tensor]
              ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`stacked_leaves`: each module name's slice (a
    view) of its leaf in ``leaves``, keyed ``"blocks/wq"``."""
    return {name: leaves["/".join(path)] if layer is None
            else leaves["/".join(path)][layer]
            for name, path, layer, _ in param_leaves(cfg)}


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Leaves(nn.Module):
    """One layer's parameters, each named as the reference's leaf and
    shaped as its slice: ``shapes`` maps a name to a shape, or to the
    shapes of a nested group, which becomes a :class:`Leaves` submodule
    of that name (an encoder-decoder layer's ``self`` and ``cross``
    attention)."""

    def __init__(self, shapes: dict, *, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            if isinstance(shape, dict):
                self.add_module(name, Leaves(shape, device=device,
                                             dtype=dtype))
            else:
                self.register_parameter(name, _empty(shape, device, dtype))


class DenseBlock(Leaves):
    """One pre-norm layer: GQA or MLA attention (by ``cfg.attn_type``) and
    the MLP, or, where the layer has a ``router``, the MoE FFN, each with a
    residual.

    Its parameters carry the reference's names and orientation (``wq``,
    ``wk``, ``wv``, ``wo`` or MLA's ``w_dkv``, ``w_uk``, ``w_uv``, ``wo``
    and ``w_dq``, ``w_uq`` or ``wq``; ``w_up``, ``w_gate`` or None,
    ``w_down``, ``ln1``, ``ln2``; a MoE layer's ``router``, expert-stacked
    ``w_up``, ``w_gate``, ``w_down`` and ``shared_up``, ``shared_gate``,
    ``shared_down`` or None)."""

    # leaves that a layer may lack; absent, they are None
    OPTIONAL = ("w_gate", "router", "shared_up", "shared_gate",
                "shared_down")

    def __init__(self, shapes: dict, *, device, dtype):
        super().__init__(shapes, device=device, dtype=dtype)
        for name in self.OPTIONAL:
            if name not in shapes:
                self.register_parameter(name, None)

    def forward(self, h, cfg: ModelConfig, cos, sin, *, cache=None,
                pos: int = 0, causal: bool = True, impl: str = "auto",
                ctx: ShardingCtx = NULL_CTX):
        x = rmsnorm(h, self.ln1)
        if cfg.attn_type == "mla":
            a, kc = mla_attention(self, x, cos, sin, mla=cfg.mla,
                                  cache=cache, cache_pos=pos, causal=causal,
                                  impl=impl, ctx=ctx)
        else:
            a, kc = gqa_attention(self, x, cos, sin, n_heads=cfg.n_heads,
                                  cache=cache, cache_pos=pos, causal=causal,
                                  impl=impl, ctx=ctx)
        h = h + a
        x = rmsnorm(h, self.ln2)
        h = h + (mlp(self, x, cfg.act, ctx) if self.router is None
                 else moe_ffn(self, x, cfg, ctx))
        h = ctx.constrain(h, "batch", "seq", "act_embed")
        return h, kc


class EncoderBlock(DenseBlock):
    """One encoder layer of an encoder-decoder model, the reference's
    ``enc_body``: non-causal self-attention, rotated at the source
    positions, then the MLP, each pre-norm with a residual.  Being
    non-causal, it never takes the flash branch."""

    def forward(self, h, cfg: ModelConfig, cos, sin, *,
                ctx: ShardingCtx = NULL_CTX):
        return super().forward(h, cfg, cos, sin, causal=False, ctx=ctx)[0]


class CrossBlock(DenseBlock):
    """A VLM's cross layer (the reference's ``group_body`` after its k
    dense layers): attention of the text to the vision embeddings
    (``ln1``), then the MLP (``ln2``), each with a residual.  ``ln3`` is
    in the schema and unused, as in the reference.

    K and V come from ``src`` (:func:`gqa_attention`'s ``kv_override``:
    no rope, no mask, the plain softmax), or, in decode, from the frozen
    cross cache ``cross_kv``: ``(k, v)``, each (B, Hkv, S_src, Dh)."""

    def forward(self, h, cfg: ModelConfig, src=None, *, cross_kv=None,
                ctx: ShardingCtx = NULL_CTX):
        x = rmsnorm(h, self.ln1)
        if cross_kv is None:
            a, _ = gqa_attention(self, x, None, None, n_heads=cfg.n_heads,
                                 kv_override=(src,), ctx=ctx)
        else:
            a = cross_attention(self, x, *cross_kv, ctx=ctx)
        h = h + a
        return h + mlp(self, rmsnorm(h, self.ln2), cfg.act, ctx)


class DecoderBlock(Leaves):
    """One decoder layer of an encoder-decoder model, the reference's
    ``dec_body``: causal self-attention (``self``, norm ``ln1``; the flash
    branch at ``FLASH_MIN_SEQ`` tokens or more), cross-attention to the
    encoder's output (``cross``, ``ln2``; K and V from ``enc`` or, in
    decode, the frozen cross cache ``cross_kv``), then the MLP (``ln3``),
    each with a residual.  Returns (h, the self-attention cache); on a
    mesh h's batch is split over the model axis too, where it divides
    (:meth:`ShardingCtx.spread_batch`)."""

    def __init__(self, shapes: dict, *, device, dtype):
        super().__init__(shapes, device=device, dtype=dtype)
        if "w_gate" not in shapes:
            self.register_parameter("w_gate", None)

    def forward(self, h, cfg: ModelConfig, cos, sin, enc=None, *,
                cache=None, pos: int = 0, cross_kv=None,
                impl: str = "auto", ctx: ShardingCtx = NULL_CTX):
        # the reference's names: ``self`` is this layer's self-attention
        a, kc = gqa_attention(self.self, rmsnorm(h, self.ln1), cos, sin,
                              n_heads=cfg.n_heads, cache=cache,
                              cache_pos=pos, impl=impl, ctx=ctx)
        h = h + a
        x = rmsnorm(h, self.ln2)
        if cross_kv is None:
            a, _ = gqa_attention(self.cross, x, None, None,
                                 n_heads=cfg.n_heads, kv_override=(enc,),
                                 ctx=ctx)
        else:
            a = cross_attention(self.cross, x, *cross_kv, ctx=ctx)
        h = h + a
        h = h + mlp(self, rmsnorm(h, self.ln3), cfg.act, ctx)
        return ctx.spread_batch(h), kc


class MambaBlock(Leaves):
    """One pre-norm mamba2 layer with a residual, the reference's
    ``_mamba_layer``; on a mesh the output's batch is split over the
    model axis too, where it divides (:meth:`ShardingCtx.spread_batch`).

    Its parameters carry the reference's names and orientation
    (``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
    ``d_skip``, ``norm_w``, ``out_proj``, ``ln1``)."""

    def forward(self, h, cfg: ModelConfig, *, conv_state=None,
                ssm_state=None, impl: str = "auto",
                ctx: ShardingCtx = NULL_CTX):
        o, caches = mamba2_block(self, rmsnorm(h, self.ln1), cfg,
                                 conv_state=conv_state, ssm_state=ssm_state,
                                 impl=impl, ctx=ctx)
        return ctx.spread_batch(h + o), caches


class Transformer(nn.Module):
    """The decoder: token embedding, the blocks of the config's family,
    the final norm and the tied or untied unembedding.

    ``blocks`` holds ``n_layers`` dense or mamba2 blocks; a MoE model
    holds its leading dense layers in ``dense0`` (empty for every other
    model) and its MoE layers in ``blocks``; a hybrid model holds its G·k
    mamba2 layers there, its trailing mamba2 layers in
    ``trailing`` and **one** :class:`DenseBlock`, ``shared``, which it
    applies after every group of k mamba2 layers (one set of weights); a
    VLM holds its G·k self-attention layers in ``blocks`` and its G cross
    layers (:class:`CrossBlock`) in ``cross``, one after each group of k;
    an encoder-decoder model holds ``encoder`` (:class:`EncoderBlock`),
    ``enc_norm`` and ``decoder`` (:class:`DecoderBlock`), and no
    ``blocks``.

    The parameters are made on ``device`` (``cuda`` unless the caller asks
    for ``cpu``; without a GPU a CUDA device raises
    :class:`~repro_torch.core.backend.BackendUnavailableError`) and left
    uninitialised: :func:`init` draws them, :func:`repro_torch.interop.
    model_params` loads the reference's.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        sch = schema(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_emb = _empty(sch["tok_emb"].shape, dev, dtype)
        self.final_norm = _empty(sch["final_norm"].shape, dev, dtype)
        self.register_parameter(
            "unembed", None if cfg.tie_embeddings
            else _empty(sch["unembed"].shape, dev, dtype))

        def per_layer(leaves: dict) -> dict:
            return {k: per_layer(d) if isinstance(d, dict) else d.shape[1:]
                    for k, d in leaves.items()}

        def stack(group: str, block) -> nn.ModuleList:
            leaves = sch.get(group, {})
            n = next(leaf_paths(leaves))[1].shape[0] if leaves else 0
            return nn.ModuleList(block(per_layer(leaves), device=dev,
                                       dtype=dtype) for _ in range(n))

        mamba = cfg.family in ("ssm", "hybrid")
        self.dense0 = stack("dense0", DenseBlock)
        self.blocks = stack("blocks", MambaBlock if mamba else DenseBlock)
        if cfg.family == "hybrid":
            self.trailing = stack("trailing", MambaBlock)
            self.shared = DenseBlock(per_layer(sch["shared"]), device=dev,
                                     dtype=dtype)
        elif cfg.family == "vlm":
            self.cross = stack("cross", CrossBlock)
        elif cfg.family == "encdec":
            self.encoder = stack("encoder", EncoderBlock)
            self.enc_norm = _empty(sch["enc_norm"].shape, dev, dtype)
            self.decoder = stack("decoder", DecoderBlock)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def embed(self, tokens: torch.Tensor,
              ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
        """The rows of ``tokens`` in ``tok_emb``.  On a mesh each rank
        looks its own tokens up in its own part of the table
        (``kernel_map``; DTensor's rule for the lookup's backward,
        ``aten.index_put`` with a batch-sharded index, fails in some torch
        releases) and no rank gathers the whole table: where the vocab is
        split, each rank gathers its rows over the embed dim (FSDP's
        gather), takes the tokens in its range (zero rows for the others)
        and the rows are summed over the vocab's axes, one row and zeros,
        so exact; where it is not, the token ids and the looked-up columns
        move (:func:`~repro_torch.parallel.sharding.lookup_by_columns`).
        The table's gradient is partial over the batch axes that split the
        tokens it meets."""
        w = self.tok_emb
        if not is_dtensor(w):
            return w[tokens.to(self.device)]
        t_spec = (ctx.batch_entry(tokens.shape[0]),)
        v_entry, e_entry = (*ctx.spec_for(("vocab", "embed"),
                                          tuple(w.shape)), None, None)[:2]
        t_axes = ctx.spec_axes(t_spec)
        if v_entry is not None:
            lo, _, groups = ctx.local_range(v_entry, w.shape[0])
            return ctx.kernel_map(
                lambda w, t: lookup_by_rows(w, t, lo, groups),
                ((v_entry,), t_spec), t_spec, w, tokens,
                partial=(t_axes, ()))
        steps = ctx.column_steps(e_entry, t_spec)
        e_axes = ctx.spec_axes((e_entry,))
        return ctx.kernel_map(
            lambda w, t: lookup_by_columns(w, t, steps),
            ((None, e_entry), t_spec), t_spec, w, tokens,
            partial=(tuple(a for a in t_axes if a not in e_axes), ()))

    def logits(self, h: torch.Tensor,
               ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
        """The final norm and the unembedding.  On a mesh each rank
        multiplies its own tokens by its own vocab rows, gathered over the
        embed dim (FSDP's gather; DTensor's plan for the product may split
        the embed dim instead, and a vocab that does not divide its axis
        then gives every rank the partial logits of the global batch).
        Where the vocab is not split, those rows are the whole table: in
        a step without a gradient whose partial logits take less than the
        table (a decode step's few tokens), the activations move instead
        (:func:`~repro_torch.parallel.sharding.matmul_by_columns`)."""
        h = rmsnorm(h, self.final_norm)
        unembed = self.tok_emb if self.unembed is None else self.unembed
        if not is_dtensor(unembed):
            return h @ unembed.T
        B, S, d = h.shape
        spec = ctx.spec_for(("batch", "seq", "vocab"),
                            (B, S, unembed.shape[0]))
        h_spec, w_spec = spec[:2], spec[2:]
        if not w_spec and not (torch.is_grad_enabled()
                               and (h.requires_grad
                                    or unembed.requires_grad)):
            e_entry = (*ctx.spec_for(("vocab", "embed"),
                                     tuple(unembed.shape)), None, None)[1]
            steps = ctx.column_steps(e_entry, h_spec)
            rows = B * S // (ctx._axis_size(h_spec[0]) if h_spec
                             and h_spec[0] else 1)
            for _, n, split, _ in steps:
                rows *= n if split else 1
            if steps and rows < d:
                return ctx.kernel_map(
                    lambda x, w: matmul_by_columns(x, w, steps),
                    (h_spec, (None, e_entry)), spec, h, unembed)
        return ctx.kernel_map(lambda x, w: x @ w.T, (h_spec, w_spec), spec,
                              h, unembed, partial=(ctx.spec_axes(w_spec),
                                                   ctx.spec_axes(h_spec)))

    def source(self, src: Optional[torch.Tensor], name: str
               ) -> torch.Tensor:
        """The source embeddings ``name`` (B, S_src, d_model) on this
        model's device and in its dtype, as the reference casts them."""
        if src is None:
            raise ValueError(f"{self.cfg.name}: the {self.cfg.family} "
                             f"forward needs {name} (B, S_src, d_model)")
        return src.to(self.device, self.tok_emb.dtype)

    def encode(self, enc_embed: torch.Tensor,
               ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
        """An encoder-decoder model's encoder stack over the source frames
        ``enc_embed`` (B, S_src, d_model), rotated at positions 0 ..
        S_src − 1, then ``enc_norm``: the K/V source of every decoder
        layer's cross-attention."""
        enc = ctx.place(self.source(enc_embed, "enc_embed"),
                        ("batch", "seq", "act_embed"))
        cos, sin = _rope(self.cfg, enc.shape[1], device=self.device)
        for blk in self.encoder:
            enc = ctx.call_block(blk, enc, self.cfg, cos, sin, ctx=ctx)
        return rmsnorm(enc, self.enc_norm)

    def forward(self, tokens: torch.Tensor, *,
                vision_embed: Optional[torch.Tensor] = None,
                enc_embed: Optional[torch.Tensor] = None,
                impl: str = "auto",
                ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
        """Token logits (B, S, vocab) for train/prefill from tokens (B, S),
        and for a VLM the vision embeddings ``vision_embed`` (B, Nv,
        d_model), for an encoder-decoder model the source frames
        ``enc_embed`` (B, S_src, d_model): the reference's batch keys.

        ``impl`` is handed to the kernel entry points: the flash
        attention, which causal self-attention over ``FLASH_MIN_SEQ``
        tokens or more runs through (never cross-attention or the
        encoder's), and every mamba2 layer's ``ssd_scan``.  Under grad
        on a GPU both go through their ``autograd.Function``: the
        forward kernel, then the backward kernels in the backward.

        With a mesh in ``ctx`` (the parameters distributed by it), the
        inputs, the same on every rank, are placed by ``"batch"``, each
        block runs under ``ctx.call_block`` and the logits come back as a
        DTensor constrained to ``("batch", "seq", "vocab")``; plain
        tensors inside (rope tables, masks) act as replicated."""
        ctx = ctx or NULL_CTX
        with ctx.scope():
            return self._forward(tokens, vision_embed, enc_embed, impl, ctx)

    def _forward(self, tokens, vision_embed, enc_embed, impl: str,
                 ctx: ShardingCtx) -> torch.Tensor:
        B, S = tokens.shape
        cfg = self.cfg
        run = ctx.call_block
        h = self.embed(ctx.place(tokens, ("batch", "seq")), ctx)
        h = ctx.constrain(h, "batch", "seq", "act_embed")
        if cfg.family == "ssm":
            for blk in self.blocks:
                h, _ = run(blk, h, cfg, impl=impl, ctx=ctx)
            return self.logits(h, ctx)
        cos, sin = _rope(cfg, S, device=self.device)
        if cfg.family == "hybrid":
            G, k, _ = _hybrid_split(cfg)
            for g in range(G):
                for blk in self.blocks[g * k:(g + 1) * k]:
                    h, _ = run(blk, h, cfg, impl=impl, ctx=ctx)
                h, _ = run(self.shared, h, cfg, cos, sin, impl=impl, ctx=ctx)
            for blk in self.trailing:
                h, _ = run(blk, h, cfg, impl=impl, ctx=ctx)
            return self.logits(h, ctx)
        if cfg.family == "vlm":
            G, k = _vlm_split(cfg)
            vis = ctx.place(self.source(vision_embed, "vision_embed"),
                            ("batch", "vis_seq", "act_embed"))
            for g in range(G):
                for blk in self.blocks[g * k:(g + 1) * k]:
                    h, _ = run(blk, h, cfg, cos, sin, impl=impl, ctx=ctx)
                h = run(self.cross[g], h, cfg, vis, ctx=ctx)
            return self.logits(h, ctx)
        if cfg.family == "encdec":
            enc = self.encode(enc_embed, ctx)
            for blk in self.decoder:
                h, _ = run(blk, h, cfg, cos, sin, enc, impl=impl, ctx=ctx)
            return self.logits(h, ctx)
        for blk in (*self.dense0, *self.blocks):
            h, _ = run(blk, h, cfg, cos, sin, impl=impl, ctx=ctx)
        return self.logits(h, ctx)


def _rope(cfg: ModelConfig, S: int, offset: int = 0, *, device):
    """cos/sin of positions offset .. offset + S - 1; MLA rotates only its
    ``qk_rope_head_dim`` part."""
    pos = torch.arange(offset, offset + S, device=device)
    hd = cfg.mla.qk_rope_head_dim if cfg.attn_type == "mla" \
        else cfg.head_dim_
    return rope_freqs(hd, cfg.rope_theta, pos)


def init(cfg: ModelConfig, *, seed: int = 0,
         generator: Optional[torch.Generator] = None, device="cuda",
         dtype: torch.dtype = torch.float32) -> Transformer:
    """A :class:`Transformer` with its parameters drawn on ``device`` as the
    schema says (ones for the norms, normals times each ``ParamDef``'s
    scale elsewhere) from ``generator``, by default a generator on
    ``device`` seeded with ``seed``.  The draws are PyTorch's, not the
    reference's: to compute what the reference computes, load its
    parameters with :func:`repro_torch.interop.model_params`."""
    model = Transformer(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, _, _, d in param_leaves(cfg):
            init_(params[name], d, generator)
    return model


# --------------------------------------------------------------------------
# layer-count helpers shared with the cache schema
# --------------------------------------------------------------------------

def _hybrid_split(cfg: ModelConfig) -> tuple[int, int, int]:
    k = cfg.hybrid_every or 6
    G = cfg.n_layers // k
    return G, k, cfg.n_layers - G * k


def _vlm_split(cfg: ModelConfig) -> tuple[int, int]:
    """n_layers = G groups of (k self layers + 1 cross layer)."""
    k = cfg.cross_attn_every or 4
    G = cfg.n_layers // (k + 1)
    if G * (k + 1) != cfg.n_layers:
        raise ValueError(f"vlm layers {cfg.n_layers} must be divisible by "
                         f"{k + 1}")
    return G, k
