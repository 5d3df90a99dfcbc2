"""minicpm3-4b — dense LM with MLA attention [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H d_ff=6400 vocab=73448; multi-head latent attention
with kv_lora_rank=256, q_lora_rank=768, qk heads split 64 nope + 32 rope,
v_head_dim=64 (HF config values).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448,
    act="silu_glu", rope_theta=10000.0, attn_type="mla",
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B",
)
