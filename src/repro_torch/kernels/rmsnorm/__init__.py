"""Row RMSNorm: plain version and CUDA kernel."""
