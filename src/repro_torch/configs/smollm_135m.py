"""smollm-135m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152; tied embeddings,
silu-GLU MLP, RoPE.  NOTE: 9 heads do not divide the 16-way model axis, so
the sharding rules replicate the head dim (DESIGN.md divisibility rule).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, head_dim=64,
    act="silu_glu", rope_theta=10000.0, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
