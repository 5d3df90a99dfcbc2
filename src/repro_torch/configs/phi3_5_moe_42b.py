"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE].

32L d_model=4096 32H (GQA kv=8) d_ff(expert)=6400 vocab=32064, every layer
MoE with 16 experts top-2.  The EP showcase arch: 16 experts over the
16-way model axis = exactly one expert per shard.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, head_dim=128,
    act="silu_glu", rope_theta=10000.0,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
