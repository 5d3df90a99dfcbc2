"""Training-side helpers of the port (the synthetic data pipeline)."""
