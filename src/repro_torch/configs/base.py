"""Config system: model architecture + input-shape + run configuration.

Every assigned architecture is a ``ModelConfig`` in
``repro_torch.configs.<id>``; ``repro_torch.configs.registry`` resolves
``--arch <id>``.  ``ShapeConfig`` holds
the assigned input-shape cells (train_4k / prefill_32k / decode_32k /
long_500k).  ``reduced()`` produces the CPU-smoke-test variant of any arch
(same family and wiring, tiny dimensions).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared: int = 0             # shared (always-on) experts
    d_ff_expert: int = 0          # per-expert hidden size
    first_dense: int = 0          # leading dense layers (deepseek style)
    d_ff_first: int = 0           # d_ff of the leading dense layers
    impl: str = "replicated"      # 'replicated' | 'alltoall' (EP dispatch)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 0
    q_lora_rank: int = 0          # 0 = no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64               # SSD chunk length
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "silu_glu"         # silu_glu | gelu | relu2
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    attn_type: str = "gqa"        # gqa | mla | none
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    hybrid_every: int = 0
    # encdec (seamless): n_layers encoder + n_layers decoder
    n_enc_layers: int = 0
    # vlm (llama-3.2-vision): a cross-attn layer after every k self layers
    cross_attn_every: int = 0
    n_vision_tokens: int = 1600   # stubbed patch-embedding count
    n_audio_frames: int = 0       # stubbed frame-embedding count (encdec)
    dtype: str = "bfloat16"
    # notes carried into DESIGN/EXPERIMENTS
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode cell?"""
        return self.family in ("ssm", "hybrid")

    @property
    def n_params(self) -> float:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim_
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.attn_type == "mla" and self.mla:
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            q = d * m.q_lora_rank + m.q_lora_rank * qdim if m.q_lora_rank \
                else d * qdim
            kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) \
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            o = self.n_heads * m.v_head_dim * d
            attn = q + kv + o
        elif self.attn_type == "none":
            attn = 0
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        glu = 3 if self.act == "silu_glu" else 2
        if self.family == "ssm":
            ssm = self.ssm
            d_in = ssm.expand * d
            nh = d_in // ssm.head_dim
            blk = d * (2 * d_in + 2 * ssm.n_groups * ssm.d_state + nh) \
                + d_in * d  # in_proj + out_proj (+ conv, dt, A, D small)
            return emb + L * blk
        if self.family == "hybrid":
            ssm = self.ssm
            d_in = ssm.expand * d
            blk = d * (2 * d_in + 2 * ssm.n_groups * ssm.d_state) + d_in * d
            shared = attn + glu * d * f
            return emb + L * blk + shared
        if self.family == "moe" and self.moe:
            mo = self.moe
            moe_layers = L - mo.first_dense
            expert = glu * d * mo.d_ff_expert
            blk = attn + (mo.n_experts + mo.n_shared) * expert + d * mo.n_experts
            dense_blk = attn + glu * d * (mo.d_ff_first or f)
            return emb + moe_layers * blk + mo.first_dense * dense_blk
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + glu * d * f)
            dec = L * (2 * attn + glu * d * f)
            return emb + enc + dec
        if self.family == "vlm":
            n_cross = L // (self.cross_attn_every + 1) if self.cross_attn_every else 0
            return emb + L * (attn + glu * d * f) + n_cross * attn
        return emb + L * (attn + glu * d * f)

    @property
    def n_active_params(self) -> float:
        """Active (per-token) parameters — MoE top-k instead of all experts."""
        if self.family != "moe" or not self.moe:
            return self.n_params
        mo = self.moe
        glu = 3 if self.act == "silu_glu" else 2
        expert = glu * self.d_model * mo.d_ff_expert
        inactive = (mo.n_experts - mo.top_k) * expert
        return self.n_params - (self.n_layers - mo.first_dense) * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_cells(cfg: ModelConfig) -> list[str]:
    """The live (arch x shape) cells for this architecture (skips per
    DESIGN.md §4: long_500k only for sub-quadratic archs)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family not in ("hybrid",) else 5),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        n_vision_tokens=8,
        n_audio_frames=16,
        dtype="float32",
    )
    if cfg.family == "encdec":
        kw["n_enc_layers"] = 2
        kw["n_layers"] = 2
    if cfg.family == "vlm":
        kw["cross_attn_every"] = 2
        kw["n_layers"] = 3  # 2 self + 1 cross per group: 3 -> one group
    if cfg.family == "hybrid":
        kw["hybrid_every"] = 2
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2,
            n_shared=min(cfg.moe.n_shared, 1),
            d_ff_expert=64,
            first_dense=min(cfg.moe.first_dense, 1),
            d_ff_first=96 if cfg.moe.first_dense else 0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk=8)
    kw.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **kw)
