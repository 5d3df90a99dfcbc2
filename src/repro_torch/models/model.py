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

The port runs the dense family with GQA attention (smollm-135m,
starcoder2-7b, nemotron-4-340b) and the SSM family (mamba2-2.7b); the
other families and MLA raise ``NotImplementedError``.  The port is
single-device: the reference's sharding context is not carried over.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models.layers import (ParamDef, gqa_attention, gqa_schema,
                                       init_, mlp, mlp_schema, rmsnorm,
                                       rope_freqs)
from repro_torch.models.ssm import mamba2_block, mamba2_schema

# what is still to be ported, by ROADMAP.md queue 1 item
_NOT_PORTED = {
    "moe": "MoE (phi3.5-moe, deepseek-v2-lite)",
    "hybrid": "the other model families (zamba2, llama-3.2-vision, "
              "seamless-m4t)",
    "vlm": "the other model families (zamba2, llama-3.2-vision, "
           "seamless-m4t)",
    "encdec": "the other model families (zamba2, llama-3.2-vision, "
              "seamless-m4t)",
    "mla": "MLA attention (minicpm3, deepseek-v2-lite)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port cannot run yet."""
    if cfg.family not in ("dense", "ssm"):
        what = _NOT_PORTED.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"ROADMAP.md queue 1 lists it under {what}")
    if cfg.family == "dense" and cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attn_type!r} is not ported yet; "
            f"ROADMAP.md queue 1 lists it under {_NOT_PORTED['mla']}")


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def _norms_schema(cfg: ModelConfig, layers: int, n: int = 2) -> dict:
    return {f"ln{i+1}": ParamDef((layers, cfg.d_model),
                                 ("layers", "act_embed"), init="ones")
            for i in range(n)}


def schema(cfg: ModelConfig) -> dict:
    """The reference's parameter schema of a dense GQA or an SSM model,
    with the blocks' leaves stacked over a leading layer axis."""
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
    else:
        sch["blocks"] = {**gqa_schema(cfg, L), **mlp_schema(cfg, L),
                         **_norms_schema(cfg, L)}
    return sch


def param_leaves(cfg: ModelConfig
                 ) -> Iterator[tuple[str, tuple, Optional[int], ParamDef]]:
    """Each parameter of a :class:`Transformer` as ``(module name, schema
    path, layer or None, ParamDef)``: ``("blocks.3.wq", ("blocks", "wq"),
    3, def)`` is slice 3 of the reference's stacked ``blocks/wq``."""
    for key, d in schema(cfg).items():
        if key == "blocks":
            for name, dd in d.items():
                for layer in range(cfg.n_layers):
                    yield f"blocks.{layer}.{name}", (key, name), layer, dd
        else:
            yield key, (key,), None, d


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class DenseBlock(nn.Module):
    """One pre-norm layer: GQA attention and the MLP, each with a residual.

    Its parameters carry the reference's names and orientation (``wq``,
    ``wk``, ``wv``, ``wo``, ``w_up``, ``w_gate`` or None, ``w_down``,
    ``ln1``, ``ln2``)."""

    def __init__(self, shapes: dict, *, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, _empty(shape, device, dtype))
        if "w_gate" not in shapes:
            self.register_parameter("w_gate", None)

    def forward(self, h, cfg: ModelConfig, cos, sin, *, cache=None,
                pos: int = 0, impl: str = "auto"):
        a, kc = gqa_attention(self, rmsnorm(h, self.ln1), cos, sin,
                              n_heads=cfg.n_heads, cache=cache,
                              cache_pos=pos, impl=impl)
        h = h + a
        h = h + mlp(self, rmsnorm(h, self.ln2), cfg.act)
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
    """The decoder: token embedding, ``n_layers`` dense or mamba2 blocks
    (by the config's family), the final norm and the tied or untied
    unembedding.

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
        per_layer = {k: d.shape[1:] for k, d in sch["blocks"].items()}
        block = MambaBlock if cfg.family == "ssm" else DenseBlock
        self.blocks = nn.ModuleList(
            block(per_layer, device=dev, dtype=dtype)
            for _ in range(cfg.n_layers))

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

        ``impl`` is handed to the kernel entry point of the family: the
        flash attention, which causal sequences of ``FLASH_MIN_SEQ``
        tokens or more run through, or every mamba2 layer's ``ssd_scan``.
        Both CUDA kernels are forward-only: call this under
        ``torch.inference_mode()`` on a GPU."""
        B, S = tokens.shape
        h = self.embed(tokens)
        if self.cfg.family == "ssm":
            for blk in self.blocks:
                h, _ = blk(h, self.cfg, impl=impl)
            return self.logits(h)
        cos, sin = _rope(self.cfg, S, device=self.device)
        for blk in self.blocks:
            h, _ = blk(h, self.cfg, cos, sin, impl=impl)
        return self.logits(h)


def _rope(cfg: ModelConfig, S: int, offset: int = 0, *, device):
    pos = torch.arange(offset, offset + S, device=device)
    return rope_freqs(cfg.head_dim_, cfg.rope_theta, pos)


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
