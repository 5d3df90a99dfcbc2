"""nemotron-4-340b — dense GQA with squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.  At 340B params
this is the memory-floor stress test of the zoo: bf16 weights alone are
~680 GB; Adam m/v in fp32 add 2.7 TB (see EXPERIMENTS.md §Dry-run for the
per-chip budget discussion and the ``state_dtype=bf16`` knob).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, head_dim=192,
    act="relu2", rope_theta=10000.0,
    source="arXiv:2402.16819 (unverified)",
)
