"""Single-token decode step of every model family the port runs.

``decode_step(model, caches, tokens, pos)`` consumes a (B, 1) token batch
and the cache dict and returns (logits (B, 1, V), caches).  The reference
scans the layers with the caches as scan inputs and outputs; here each
layer writes its new cache entries *in place* into its slice of the
stacked caches (keys and values, or MLA's compressed latent, at ``pos``;
a mamba2 layer's conv tail and state), so the returned caches are the
same tensors that came in.  A VLM's or an encoder-decoder model's cross
layers read a frozen cross K/V cache, built once per request by
:func:`prefill_cross_cache` (after :func:`encode` for an encoder-decoder
model), and never write it.

With a mesh in ``ctx`` (the model distributed by it, the caches placed by
it: :func:`~repro_torch.serve.kvcache.init_cache`), the step runs on
DTensors; a GQA layer with ``ctx.flash_decode`` on a mesh with a
``"model"`` axis attends over its sequence-sharded cache by
flash-decoding (:func:`~repro_torch.models.layers.flash_decode_gqa`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import (Transformer, _hybrid_split, _rope,
                                      _vlm_split)
from repro_torch.parallel.sharding import NULL_CTX, ShardingCtx


def _attn_cache(c: dict, layer: int):
    """Layer ``layer``'s slice of an attention cache group: MLA's ``ckv``
    (B, S_max, lora + rope), or the GQA ``(k, v)`` pair."""
    if "ckv" in c:
        return c["ckv"][layer]
    return c["k"][layer], c["v"][layer]


# the cache group that holds each family's self-attention K/V
_SELF_CACHE = {"hybrid": "shared", "encdec": "self"}


def _max_cache_len(caches: dict, cfg) -> int:
    """The sequence length of the self-attention cache the family keeps."""
    c = caches[_SELF_CACHE.get(cfg.family, "blocks")]
    return c["ckv"].shape[2] if "ckv" in c else c["k"].shape[3]


def _mamba_layers(blocks, cfg, caches: dict, h, first: int = 0,
                  ctx: ShardingCtx = NULL_CTX):
    """Run ``blocks``, block i with cache slot ``first + i``."""
    for i, blk in enumerate(blocks):
        conv, state = caches["conv"][first + i], caches["state"][first + i]
        h, (new_conv, new_state) = blk(h, cfg, conv_state=conv,
                                       ssm_state=state, ctx=ctx)
        # new_conv is a slice of a window built with cat, not a view of
        # the cache slot it overwrites
        conv.copy_(new_conv)
        state.copy_(new_state)
    return h


def decode_step(model: Transformer, caches: dict, tokens: torch.Tensor,
                pos: int, ctx: Optional[ShardingCtx] = None):
    """One token for the whole batch at write position ``pos`` (an int;
    an SSM model's step does not depend on it).

    A MoE model runs its leading dense layers on ``caches["dense0"]``,
    then its MoE layers on ``caches["blocks"]``, each MoE FFN on the
    step's B tokens.  A hybrid model runs group g's k mamba2 layers, then
    the shared block with KV cache slot g, for each group, then its
    trailing layers.  A VLM runs group g's k dense layers, then cross
    layer g on slot g of the frozen ``caches["cross"]``; an
    encoder-decoder model runs each decoder layer on its ``self`` cache
    slot and its ``cross`` slot.  The self-attention caches are updated
    in place; every cache comes back."""
    ctx = ctx or NULL_CTX
    # DTensor's view ops (a layer's slice of a cache) set the version
    # counter of the views they make, which inference mode forbids: a
    # sharded step runs under no_grad
    no_grad = torch.inference_mode() if ctx.mesh is None else torch.no_grad()
    with no_grad, ctx.scope():
        return _decode(model, caches, tokens, pos, ctx)


def _decode(model: Transformer, caches: dict, tokens: torch.Tensor,
            pos: int, ctx: ShardingCtx):
    cfg = model.cfg
    B, S1 = tokens.shape
    h = model.embed(ctx.place(tokens, ("batch", None)), ctx)
    h = ctx.constrain(h, "batch", None, "act_embed")
    if cfg.family == "ssm":
        h = _mamba_layers(model.blocks, cfg, caches["blocks"], h, ctx=ctx)
        return model.logits(h, ctx), caches
    max_seq = _max_cache_len(caches, cfg)
    if not 0 <= pos <= max_seq - S1:
        raise ValueError(f"write position {pos} (+{S1}) outside the cache "
                         f"of length {max_seq}")
    # the rope rows of positions pos .. pos + S1 - 1 (the reference slices
    # them out of the table for the whole cache length; same values)
    cos, sin = _rope(cfg, S1, offset=pos, device=model.device)
    if cfg.family == "hybrid":
        G, k, _ = _hybrid_split(cfg)
        for g in range(G):
            h = _mamba_layers(model.blocks[g * k:(g + 1) * k], cfg,
                              caches["blocks"], h, first=g * k, ctx=ctx)
            h, _ = model.shared(h, cfg, cos, sin, pos=pos,
                                cache=_attn_cache(caches["shared"], g),
                                ctx=ctx)
        if len(model.trailing):
            h = _mamba_layers(model.trailing, cfg, caches["trailing"], h,
                              ctx=ctx)
        return model.logits(h, ctx), caches
    if cfg.family == "vlm":
        G, k = _vlm_split(cfg)
        for g in range(G):
            for layer in range(g * k, (g + 1) * k):
                h, _ = model.blocks[layer](
                    h, cfg, cos, sin, pos=pos,
                    cache=_attn_cache(caches["blocks"], layer), ctx=ctx)
            h = model.cross[g](h, cfg,
                               cross_kv=_attn_cache(caches["cross"], g),
                               ctx=ctx)
        return model.logits(h, ctx), caches
    if cfg.family == "encdec":
        for layer, blk in enumerate(model.decoder):
            h, _ = blk(h, cfg, cos, sin, pos=pos,
                       cache=_attn_cache(caches["self"], layer),
                       cross_kv=_attn_cache(caches["cross"], layer), ctx=ctx)
        return model.logits(h, ctx), caches
    for group, blocks in (("dense0", model.dense0), ("blocks", model.blocks)):
        for layer, blk in enumerate(blocks):
            h, _ = blk(h, cfg, cos, sin, pos=pos,
                       cache=_attn_cache(caches[group], layer), ctx=ctx)
    return model.logits(h, ctx), caches


@torch.inference_mode()
def encode(model: Transformer, enc_embed: torch.Tensor) -> torch.Tensor:
    """The encoder stack of an encoder-decoder model over the source frames
    ``enc_embed`` (B, S_src, d_model), ending in ``enc_norm``: what
    :func:`prefill_cross_cache` projects into the decoder's cross cache."""
    return model.encode(enc_embed)


@torch.inference_mode()
def prefill_cross_cache(model: Transformer, src: torch.Tensor,
                        which: str = "cross") -> dict:
    """The frozen cross-attention cache from source embeddings ``src``
    (B, S_src, d_model): ``{"k", "v"}``, each (G or L, B, Hkv, S_src,
    Dh), projected by each cross layer's ``wk`` / ``wv`` without rope.

    A VLM's comes from its G ``cross`` layers over the vision embeddings
    (``which="cross"``); an encoder-decoder model's from each decoder
    layer's ``cross`` attention over :func:`encode`'s output (the
    reference passes ``which="decoder"``; a model without ``cross``
    layers reads the decoder's either way, as the reference does)."""
    src = model.source(src, "src")
    layers = (model.cross if which == "cross" and model.cfg.family == "vlm"
              else [blk.cross for blk in model.decoder])
    return {name: torch.stack([torch.einsum("bsd,dhk->bhsk", src,
                                            getattr(p, "w" + name))
                               for p in layers])
            for name in ("k", "v")}
