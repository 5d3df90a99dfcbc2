"""Training-side modules of the port: the synthetic data pipeline, AdamW,
the train step and checkpoints."""
