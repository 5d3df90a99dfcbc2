"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MLA kv_lora=512;
layer 0 dense (d_ff 10944, HF config), layers 1..26 MoE with 64 routed
experts top-6 plus 2 shared experts.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    act="silu_glu", rope_theta=10000.0, attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  first_dense=1, d_ff_first=10944),
    source="arXiv:2405.04434",
)
