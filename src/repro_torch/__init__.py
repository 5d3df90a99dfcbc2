"""repro_torch — the TOFA placement system on PyTorch and CUDA.

A port of the ``repro`` package's placement main path to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper in place of the Pallas TPU
kernels.  It imports nothing of ``repro`` and never imports JAX: the
NumPy modules it needs are its own copies.  Its engine runs on ``cuda``
by default; the CPU runs only when the caller asks for it.
"""
