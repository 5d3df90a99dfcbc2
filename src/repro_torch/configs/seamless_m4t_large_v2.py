"""seamless-m4t-large-v2 — encoder-decoder multimodal translator
[arXiv:2308.11596; hf].

24L(enc) + 24L(dec) d_model=1024 16H d_ff=8192 vocab=256206.  The speech
frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings as encoder input; the text decoder runs
self + cross attention.  Decode caches: self-KV + frozen cross-KV.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    act="gelu", rope_theta=10000.0,
    source="arXiv:2308.11596",
)
