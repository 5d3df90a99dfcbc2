"""Mamba2 SSD chunked scan: plain version and CUDA kernel."""
