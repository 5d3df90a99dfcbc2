"""starcoder2-7b — dense GQA code LM [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152; RoPE, GQA.
(The HF config uses layernorm + gelu pre-GLU-less MLP; we keep the
assignment's d_ff with a plain gelu MLP.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152, head_dim=128,
    act="gelu", rope_theta=100000.0,
    source="arXiv:2402.19173",
)
