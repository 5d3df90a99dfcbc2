"""mamba2-2.7b — attention-free SSM via state-space duality
[arXiv:2405.21060; unverified].

64L d_model=2560 vocab=50280, ssm_state=128, expand=2 (d_inner 5120),
head_dim=64 (80 heads), conv window 4.  Sub-quadratic: runs the long_500k
cell (decode state is O(1) in sequence length).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=80, n_kv_heads=0,
    d_ff=0, vocab=50280, attn_type="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=64),
    source="arXiv:2405.21060 (unverified)",
)
