"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 32H d_ff=14336 vocab=32000, ssm_state=64.  One SHARED
attention+MLP block (true weight sharing) applied after every 6 mamba2
layers (13 applications + 3 trailing mamba layers).  Sub-quadratic family:
runs long_500k (shared-block KV caches are the only seq-length state).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    act="silu_glu", rope_theta=10000.0, hybrid_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64),
    source="arXiv:2411.15242 (unverified)",
)
