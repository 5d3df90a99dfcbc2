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

The port runs the dense family with GQA or MLA attention (smollm-135m,
starcoder2-7b, nemotron-4-340b, minicpm3-4b), the MoE family
(phi3.5-moe-42b; deepseek-v2-lite-16b, whose leading dense layers sit in
``dense0`` before the MoE ``blocks``), the SSM family (mamba2-2.7b) and
the hybrid family (zamba2-7b: groups of mamba2 layers, each followed by
one shared attention block, then trailing mamba2 layers); VLM and
encoder-decoder models raise ``NotImplementedError``.  The port is
single-device: the reference's sharding context is not carried over, and
a MoE layer runs all its experts on the one device
(:func:`~repro_torch.models.moe.moe_ffn_local`).
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models.layers import (ParamDef, gqa_attention, gqa_schema,
                                       init_, mla_attention, mla_schema, mlp,
                                       mlp_schema, rmsnorm, rope_freqs)
from repro_torch.models.moe import moe_ffn_local, moe_schema
from repro_torch.models.ssm import mamba2_block, mamba2_schema

# what is still to be ported, by ROADMAP.md queue 1 item
_NOT_PORTED = {
    "vlm": "the other model families (llama-3.2-vision, seamless-m4t)",
    "encdec": "the other model families (llama-3.2-vision, seamless-m4t)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port cannot run yet."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        what = _NOT_PORTED.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"ROADMAP.md queue 1 lists it under {what}")
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
    model's G·k mamba2 layers), for a MoE model with leading dense layers
    ``dense0`` (attention + an MLP of ``d_ff_first``) before ``blocks``,
    and for a hybrid model ``trailing`` (its last n_layers − G·k mamba2
    layers) and ``shared`` (its one attention + MLP block, stacked over
    1)."""
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


def param_leaves(cfg: ModelConfig
                 ) -> Iterator[tuple[str, tuple, Optional[int], ParamDef]]:
    """Each parameter of a :class:`Transformer` as ``(module name, schema
    path, layer or None, ParamDef)``: ``("blocks.3.wq", ("blocks", "wq"),
    3, def)`` is slice 3 of the reference's stacked ``blocks/wq``, and a
    hybrid model's ``("shared.wq", ("shared", "wq"), 0, def)`` the one
    slice of ``shared/wq``."""
    for key, d in schema(cfg).items():
        if not isinstance(d, dict):
            yield key, (key,), None, d
            continue
        for name, dd in d.items():
            if key == "shared":
                yield f"shared.{name}", (key, name), 0, dd
                continue
            for layer in range(dd.shape[0]):
                yield f"{key}.{layer}.{name}", (key, name), layer, dd


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class DenseBlock(nn.Module):
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
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, _empty(shape, device, dtype))
        for name in self.OPTIONAL:
            if name not in shapes:
                self.register_parameter(name, None)

    def forward(self, h, cfg: ModelConfig, cos, sin, *, cache=None,
                pos: int = 0, impl: str = "auto"):
        x = rmsnorm(h, self.ln1)
        if cfg.attn_type == "mla":
            a, kc = mla_attention(self, x, cos, sin, mla=cfg.mla,
                                  cache=cache, cache_pos=pos, impl=impl)
        else:
            a, kc = gqa_attention(self, x, cos, sin, n_heads=cfg.n_heads,
                                  cache=cache, cache_pos=pos, impl=impl)
        h = h + a
        x = rmsnorm(h, self.ln2)
        h = h + (mlp(self, x, cfg.act) if self.router is None
                 else moe_ffn_local(self, x, cfg))
        return h, kc


class MambaBlock(nn.Module):
    """One pre-norm mamba2 layer with a residual, the reference's
    ``_mamba_layer``.

    Its parameters carry the reference's names and orientation
    (``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
    ``d_skip``, ``norm_w``, ``out_proj``, ``ln1``)."""

    def __init__(self, shapes: dict, *, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, _empty(shape, device, dtype))

    def forward(self, h, cfg: ModelConfig, *, conv_state=None,
                ssm_state=None, impl: str = "auto"):
        o, caches = mamba2_block(self, rmsnorm(h, self.ln1), cfg,
                                 conv_state=conv_state, ssm_state=ssm_state,
                                 impl=impl)
        return h + o, caches


class Transformer(nn.Module):
    """The decoder: token embedding, the blocks of the config's family,
    the final norm and the tied or untied unembedding.

    ``blocks`` holds ``n_layers`` dense or mamba2 blocks; a MoE model
    holds its leading dense layers in ``dense0`` (empty for every other
    model) and its MoE layers in ``blocks``; a hybrid model holds its G·k
    mamba2 layers there, its trailing mamba2 layers in
    ``trailing`` and **one** :class:`DenseBlock`, ``shared``, which it
    applies after every group of k mamba2 layers (one set of weights).

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

        def stack(group: str, block) -> nn.ModuleList:
            leaves = sch.get(group, {})
            per_layer = {k: d.shape[1:] for k, d in leaves.items()}
            n = next(iter(leaves.values())).shape[0] if leaves else 0
            return nn.ModuleList(block(per_layer, device=dev, dtype=dtype)
                                 for _ in range(n))

        mamba = cfg.family in ("ssm", "hybrid")
        self.dense0 = stack("dense0", DenseBlock)
        self.blocks = stack("blocks", MambaBlock if mamba else DenseBlock)
        if cfg.family == "hybrid":
            self.trailing = stack("trailing", MambaBlock)
            self.shared = DenseBlock(
                {k: d.shape[1:] for k, d in sch["shared"].items()},
                device=dev, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok_emb[tokens.to(self.device)]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(h, self.final_norm)
        unembed = self.tok_emb if self.unembed is None else self.unembed
        return h @ unembed.T

    def forward(self, tokens: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
        """Token logits (B, S, vocab) for train/prefill from tokens (B, S).

        ``impl`` is handed to the kernel entry points: the flash
        attention, which causal sequences of ``FLASH_MIN_SEQ`` tokens or
        more run through, and every mamba2 layer's ``ssd_scan``.  Both
        CUDA kernels are forward-only: call this under
        ``torch.inference_mode()`` on a GPU."""
        B, S = tokens.shape
        cfg = self.cfg
        h = self.embed(tokens)
        if cfg.family == "ssm":
            for blk in self.blocks:
                h, _ = blk(h, cfg, impl=impl)
            return self.logits(h)
        cos, sin = _rope(cfg, S, device=self.device)
        if cfg.family == "hybrid":
            G, k, _ = _hybrid_split(cfg)
            for g in range(G):
                for blk in self.blocks[g * k:(g + 1) * k]:
                    h, _ = blk(h, cfg, impl=impl)
                h, _ = self.shared(h, cfg, cos, sin, impl=impl)
            for blk in self.trailing:
                h, _ = blk(h, cfg, impl=impl)
            return self.logits(h)
        for blk in (*self.dense0, *self.blocks):
            h, _ = blk(h, cfg, cos, sin, impl=impl)
        return self.logits(h)


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
