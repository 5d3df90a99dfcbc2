"""Implicit hop distances: torus and fat-tree kernels."""
