"""Decode caches for every architecture family.

Cache schemas are ``ParamDef`` trees, the same shapes and dtypes as the
reference's, so their byte counts (what the placement service sizes KV
shards from) are equal:

  GQA      k/v       (L, B, Hkv, S_max, Dh)
  MLA      latent    (L, B, S_max, lora+rope)
  SSM      conv      (L, B, d_conv-1, C) ; state (L, B, H, P, N) float32
  hybrid   mamba caches + shared-block KV per application (G, B, ...)
  encdec   decoder self KV + frozen cross K/V over the source
  vlm      self KV + frozen cross K/V over the vision tokens

:func:`cache_schema` covers every family (shape arithmetic only);
:func:`abstract_cache` gives its shapes and dtypes without storage (the
dry run's); :func:`init_cache` allocates the caches the port can decode with: the
dense and MoE families (GQA or MLA), the SSM, hybrid, VLM and
encoder-decoder families.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models.layers import ParamDef
from repro_torch.models.model import _hybrid_split, _vlm_split, check_ported
from repro_torch.parallel.sharding import NULL_CTX, ShardingCtx


def _gqa_kv(cfg: ModelConfig, L: int, B: int, S: int) -> dict:
    hd = cfg.head_dim_
    shp = (L, B, cfg.n_kv_heads, S, hd)
    axes = ("layers", "batch", "cache_heads", "cache_seq", None)
    return {"k": ParamDef(shp, axes, init="zeros"),
            "v": ParamDef(shp, axes, init="zeros")}


def _mla_latent(cfg: ModelConfig, L: int, B: int, S: int) -> dict:
    m = cfg.mla
    shp = (L, B, S, m.kv_lora_rank + m.qk_rope_head_dim)
    return {"ckv": ParamDef(shp, ("layers", "batch", "cache_seq", None),
                            init="zeros")}


def _attn_cache(cfg: ModelConfig, L: int, B: int, S: int) -> dict:
    if cfg.attn_type == "mla":
        return _mla_latent(cfg, L, B, S)
    return _gqa_kv(cfg, L, B, S)


def _ssm_cache(cfg: ModelConfig, L: int, B: int) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return {
        "conv": ParamDef((L, B, s.d_conv - 1, conv_ch),
                         ("layers", "batch", None, "ssm_inner"),
                         init="zeros"),
        "state": ParamDef((L, B, H, s.head_dim, s.d_state),
                          ("layers", "batch", "heads", None, None),
                          init="zeros", dtype=torch.float32),
    }


def cache_schema(cfg: ModelConfig, batch: int, max_seq: int,
                 src_len: int | None = None) -> dict:
    fam = cfg.family
    if fam in ("dense", "moe"):
        sch = {}
        if fam == "moe" and cfg.moe and cfg.moe.first_dense:
            sch["dense0"] = _attn_cache(cfg, cfg.moe.first_dense, batch, max_seq)
            sch["blocks"] = _attn_cache(cfg, cfg.n_layers - cfg.moe.first_dense,
                                        batch, max_seq)
        else:
            sch["blocks"] = _attn_cache(cfg, cfg.n_layers, batch, max_seq)
        return sch
    if fam == "ssm":
        return {"blocks": _ssm_cache(cfg, cfg.n_layers, batch)}
    if fam == "hybrid":
        G, k, trail = _hybrid_split(cfg)
        sch = {"blocks": _ssm_cache(cfg, G * k, batch),
               "shared": _attn_cache(cfg, G, batch, max_seq)}
        if trail:
            sch["trailing"] = _ssm_cache(cfg, trail, batch)
        return sch
    if fam == "vlm":
        G, k = _vlm_split(cfg)
        return {"blocks": _attn_cache(cfg, G * k, batch, max_seq),
                "cross": _gqa_kv(cfg, G, batch, cfg.n_vision_tokens)}
    if fam == "encdec":
        L = cfg.n_layers
        return {"self": _attn_cache(cfg, L, batch, max_seq),
                "cross": _gqa_kv(cfg, L, batch, src_len or max_seq)}
    raise ValueError(fam)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               dtype: torch.dtype = torch.float32, device="cuda",
               src_len: int | None = None,
               ctx: ShardingCtx | None = None) -> dict:
    """Zeroed decode caches made on ``device``, in ``dtype`` except where
    the schema pins one: for a dense GQA model ``{"blocks": {"k", "v"}}``,
    each (L, B, Hkv, max_seq, Dh); for a dense MLA model ``{"blocks":
    {"ckv"}}``, (L, B, max_seq, lora + rope); a MoE model has the same
    per layer, with its leading dense layers' in ``dense0`` (L =
    ``first_dense``) and its MoE layers' in ``blocks``; for an SSM model
    ``{"blocks": {"conv", "state"}}``, the conv tail (L, B, d_conv - 1, C)
    and the state (L, B, H, P, N) always in float32 (``max_seq`` does not
    enter: the caches are O(1) in sequence length); for a hybrid model the
    mamba2 caches of its G·k grouped layers (``blocks``) and of its
    trailing layers (``trailing``), and ``shared``: the shared block's
    k/v, one slot per application, (G, B, Hkv, max_seq, Dh); for a VLM
    the self-attention layers' k/v (``blocks``, G·k layers) and the cross
    layers' (``cross``, (G, B, Hkv, n_vision_tokens, Dh)); for an
    encoder-decoder model the decoder's self-attention k/v (``self``) and
    its cross k/v over ``src_len`` source positions (``cross``, (L, B,
    Hkv, src_len or max_seq, Dh)).  The cross caches are zeros here:
    :func:`~repro_torch.serve.decode.prefill_cross_cache` builds the
    frozen ones.  With a mesh in ``ctx``, each cache is a DTensor placed
    by its axes (``cache_seq`` on the model axis, ``batch`` on the batch
    axes)."""
    check_ported(cfg)
    dev = resolve_device(device)
    ctx = ctx or NULL_CTX
    sch = cache_schema(cfg, batch, max_seq, src_len=src_len)
    return {grp: {name: ctx.place(torch.zeros(d.shape,
                                              dtype=d.dtype or dtype,
                                              device=dev), d.axes)
                  for name, d in leaves.items()}
            for grp, leaves in sch.items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   src_len: int | None = None) -> dict:
    """The cache tree of :func:`cache_schema` as tensors on the ``meta``
    device, in ``dtype`` except where the schema pins one: the dry run's
    stand-ins (the reference's ``ShapeDtypeStruct`` tree), no storage."""
    sch = cache_schema(cfg, batch, max_seq, src_len=src_len)
    return {grp: {name: torch.empty(d.shape, dtype=d.dtype or dtype,
                                    device="meta")
                  for name, d in leaves.items()}
            for grp, leaves in sch.items()}
