"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``<name>/ref.py``) and a device-dispatching wrapper
(``<name>/ops.py``).

``LAUNCHES`` counts kernel launches per kernel name.  Each wrapper adds
one where it launches its CUDA kernel and nowhere else, so a run can show
that the main path went through the kernels: zero the counts with
:func:`reset_launches`, drive the path, read them back.  ``SHAPES`` keeps,
beside each count, the largest shape the kernel was launched at since the
last reset: (B, n) for ``swap_select``, (B, m, k) for the hop kernels.
"""
import math

LAUNCHES = {"swap_select": 0, "torus_hop": 0, "fattree_hop": 0}
SHAPES: dict = {name: None for name in LAUNCHES}


def count_launch(name: str, shape: tuple) -> None:
    """Record one launch of kernel ``name`` at ``shape``."""
    LAUNCHES[name] += 1
    old = SHAPES[name]
    if old is None or math.prod(shape) > math.prod(old):
        SHAPES[name] = tuple(shape)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SHAPES[name] = None
