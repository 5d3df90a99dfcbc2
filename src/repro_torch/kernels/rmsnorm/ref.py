"""RMSNorm oracle — the model's own :func:`repro_torch.models.layers.rmsnorm`.

It casts ``rsqrt(mean(x^2) + eps)`` to ``x.dtype`` before the multiply,
while the kernel stays in float32 to the end, so the two agree exactly in
float32 only up to rounding and in bfloat16 within a tolerance.
"""
from repro_torch.models.layers import rmsnorm as rmsnorm_ref  # noqa: F401
