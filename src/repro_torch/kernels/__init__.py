"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``<name>/ref.py``) and a device-dispatching wrapper
(``<name>/ops.py``).

``LAUNCHES`` counts kernel launches per kernel name.  Each wrapper adds
one where it launches its CUDA kernel and nowhere else, so a run can show
that the main path went through the kernels: zero the counts with
:func:`reset_launches`, drive the path, read them back.  ``SHAPES`` keeps,
beside each count, the largest shape the kernel was launched at since the
last reset: (B, n) for ``swap_select``, (B, m, k) for the hop kernels,
(n,) for ``swap_gain``, (B, H, Hkv, Sq, Sk, Dh) for ``flash_attention``
and ``flash_attention_bwd``, (rows, D) for ``rmsnorm`` and (B, H, G, S,
P, N, chunk) for ``ssd_scan`` and ``ssd_scan_bwd``.  The two ``_bwd``
kernels are the backward passes of ``flash_attention`` and ``ssd_scan``
(the ``autograd.Function`` classes of their wrappers launch them); each
counts one launch a backward.  ``SHAPE_COUNTS`` keeps, per kernel, a
:class:`collections.Counter` of launches by shape since the last reset,
so a run can say which shapes the path launches most often.

Every wrapper chooses by the device of the tensors it is handed
(:func:`use_kernel`): ``impl="auto"`` launches the CUDA kernel for tensors
on a GPU and runs the plain version for tensors on the CPU;
``impl="kernel"`` insists on the kernel (and raises for CPU tensors);
``impl="ref"`` runs the plain version on any device.  A kernel that fails
to build or launch raises; nothing falls back.
"""
import math
from collections import Counter

import torch

LAUNCHES = {"swap_select": 0, "torus_hop": 0, "fattree_hop": 0,
            "swap_gain": 0, "flash_attention": 0, "rmsnorm": 0,
            "ssd_scan": 0, "flash_attention_bwd": 0, "ssd_scan_bwd": 0}
SHAPES: dict = {name: None for name in LAUNCHES}
SHAPE_COUNTS: dict = {name: Counter() for name in LAUNCHES}


def count_launch(name: str, shape: tuple) -> None:
    """Record one launch of kernel ``name`` at ``shape``."""
    LAUNCHES[name] += 1
    SHAPE_COUNTS[name][shape] += 1
    old = SHAPES[name]
    if old is None or math.prod(shape) > math.prod(old):
        SHAPES[name] = tuple(shape)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SHAPES[name] = None
        SHAPE_COUNTS[name].clear()


# The profile tags of the plain-version regions running now, innermost
# last, and whether a step is being profiled: while
# ``repro_torch.core.profiler.profile_torch`` records a step it charges the
# bytes of each operation to the innermost tag (the reference's profiler
# reads the same tags from the HLO's op names).
PROFILE_TAGS: list = []
PROFILING = [False]
# the key of an autograd node's metadata that carries its tag
PROFILE_TAG_KEY = "repro_profile_tag"


def tagged(tag: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` (a kernel's plain version) as the profile
    region ``tag``.  While a step is profiled, the autograd nodes from the
    result back to ``args`` carry the tag too, so that the backward's
    operations are charged to it.  What ``fn`` computes is unchanged."""
    PROFILE_TAGS.append(tag)
    try:
        out = fn(*args, **kwargs)
    finally:
        PROFILE_TAGS.pop()
    if PROFILING[0] and torch.is_grad_enabled():
        _tag_graph(tag, out, args)
    return out


def _tag_graph(tag: str, out, inputs) -> None:
    """Tag every autograd node between ``out`` and ``inputs``."""
    stop = {t.grad_fn for t in inputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None}
    outs = out if isinstance(out, (tuple, list)) else (out,)
    todo = [t.grad_fn for t in outs if isinstance(t, torch.Tensor)]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in stop or node in seen \
                or node.name().endswith("AccumulateGrad"):
            continue
        seen.add(node)
        node.metadata[PROFILE_TAG_KEY] = tag
        todo.extend(n for n, _ in node.next_functions)


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """Resolve ``impl`` for a tensor: True = CUDA kernel, False = plain."""
    if impl == "auto":
        return t.device.type == "cuda"
    if impl == "kernel":
        if t.device.type != "cuda":
            raise ValueError("the CUDA kernel needs tensors on a CUDA "
                             f"device, got {t.device}")
        return True
    if impl == "ref":
        return False
    raise ValueError(f"impl must be auto|kernel|ref, got {impl!r}")


def launch(lib, fn, name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` of ``lib`` on
    ``device``'s current stream; raise when it returns a CUDA error.

    Where ``device`` is the current device already, the call enters no
    device context and reads the raw stream handle without building a
    ``torch.cuda.Stream``: at the placement path's small shapes the
    wrapper's host time is the larger cost of a launch."""
    idx = device.index
    if idx is not None and idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
