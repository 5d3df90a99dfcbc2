"""llama-3.2-vision-11b — VLM text backbone with cross-attention layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; a cross-attention
layer after every 4 self-attention layers (8 cross layers).  The vision
tower is a STUB per the assignment: ``input_specs`` provides precomputed
patch embeddings (B, 1600, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    act="silu_glu", rope_theta=500000.0,
    cross_attn_every=4, n_vision_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision (unverified)",
)
