"""Online-softmax (flash) attention: plain version and CUDA kernel."""
