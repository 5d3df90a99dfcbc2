"""Pluggable array backend for the mapping hot path.

The placement stack is NumPy-first: every public function takes and returns
``np.ndarray``.  Two backends serve the hot kernels:

* ``numpy`` — the vectorized NumPy implementations in
  :mod:`repro_torch.core.mapping`, pinned to float64 (the quality/parity
  baseline);
* ``torch`` — :mod:`repro_torch.core.mapping_torch`, which refines every
  candidate placement of TOFA's multi-candidate search along one leading
  batch dimension on a torch device and keeps the per-(topology, health)
  distance matrices device-resident across placements.  Its kernels are
  the hand-written CUDA kernels of :mod:`repro_torch.kernels` when the
  tensors live on a GPU, and their plain PyTorch versions when the caller
  asked for the CPU.

Selection (first match wins):

* ``backend.use("torch", device=...)`` context manager (tests, scripts);
* ``PlacementEngine(backend=..., device=...)`` — the engine wraps each
  placement call; its default is the torch backend on ``cuda``;
* :func:`set_backend` — the process-wide choice;
* default: the torch backend on ``cuda``, resolved at first use.

**The card is the default device.**  ``TorchBackend()`` targets ``cuda``
and raises :class:`BackendUnavailableError` when no GPU is visible — it
never quietly runs on the CPU.  That holds for every entry point: a
mapping function or policy called outside any scope resolves the default
and raises without a GPU.  The CPU runs only when the caller asks for it
(``device="cpu"``, or ``"numpy"`` for the NumPy kernels).

Dtype policy: float64 by default — with in-tree workloads every guest
weight and route distance is an exactly-representable integer, so the
device kernels reproduce the NumPy placements *bit-for-bit* — and float32
on request (``dtype="float32"``) when throughput matters more than
cross-backend parity.  Placements are integer node-id arrays on every
backend, never floats.
"""
from __future__ import annotations

import contextlib
import os
from collections import OrderedDict
from typing import Iterator, Optional

import numpy as np
import torch


class BackendUnavailableError(RuntimeError):
    """Requested backend or device cannot be used here."""


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, checked: a CUDA device when no GPU
    is visible raises :class:`BackendUnavailableError` (nothing quietly
    runs on the CPU), and only ``cuda`` and ``cpu`` devices are taken."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BackendUnavailableError(
            f"the port targets {str(device)!r} but no CUDA device is "
            f"visible; pass device='cpu' to run the plain PyTorch versions "
            f"on the host")
    if dev.type not in ("cuda", "cpu"):
        raise BackendUnavailableError(
            f"the port's device must be cuda or cpu, got {str(device)!r}")
    return dev


class NumpyBackend:
    """The vectorized NumPy kernels run as-is."""

    name = "numpy"
    is_torch = False
    dtype = "float64"          # the NumPy kernels are pinned to float64

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<backend {self.name} dtype={self.dtype}>"


class TorchBackend:
    """Torch backend: batched device kernels + device-resident matrices.

    ``device`` is where every kernel runs (``"cuda"`` by default; a CUDA
    device string such as ``"cuda:1"``, or ``"cpu"`` when the caller asks
    for the plain PyTorch versions).  ``dtype`` selects the compute
    precision (placement ids stay integers regardless).

    ``devices`` are the devices a batched refine shards its candidate
    stack over (:func:`~repro_torch.core.mapping_torch.refine_many`): by
    default every visible CUDA device for a CUDA backend, capped by
    ``REPRO_TORCH_DEVICES`` (0 or unset: all), and ``[device]`` for a CPU
    one; a list such as ``["cpu"] * 4`` sets them.
    """

    name = "torch"
    is_torch = True

    def __init__(self, dtype: str = "float64", device: str = "cuda",
                 max_cached_devices: int = 8, devices=None):
        if dtype not in ("float32", "float64"):
            raise ValueError(f"torch backend dtype must be float32|float64, "
                             f"got {dtype!r}")
        dev = resolve_device(device)
        self.dtype = dtype
        self.device = dev
        self.devices = ([resolve_device(d) for d in devices]
                        if devices is not None else _default_devices(dev))
        # host ndarray -> device tensor, LRU by object identity.  The
        # engine hands the same cached D / Eq. 1 weight matrix object to
        # every placement against one (topology, health) state, so
        # identity is exactly the right key: one transfer per health
        # state, then every job in the batch reuses the resident copy.
        self._device: OrderedDict[tuple, tuple[np.ndarray, torch.Tensor]] = \
            OrderedDict()
        self._max_cached = max_cached_devices
        # the counters make the one-transfer-per-epoch contract testable
        # (zero new transfers across a warm state-churn sequence)
        self.stats = {"transfers": 0, "transfer_hits": 0}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<backend {self.name} dtype={self.dtype} device={self.device}>"

    @property
    def np_dtype(self):
        return np.float32 if self.dtype == "float32" else np.float64

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "float32" else torch.float64

    def device_matrix(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Device-resident copy of a host matrix in the compute dtype,
        cached by identity, on ``device`` (by default the backend's).

        The host array is kept referenced so ``id()`` cannot be recycled
        while the cache entry lives.

        A :class:`~repro_torch.core.lazydist.LazyDistance` must never land
        here — densifying it on device would defeat the O(n)-memory
        contract.  The torch mapping layer ships its ``implicit`` coords
        instead (``mapping_torch._device_distances``); anything else is a
        dispatch bug, surfaced eagerly.
        """
        if hasattr(arr, "implicit"):
            raise TypeError(
                "refusing to densify a LazyDistance onto device; use its "
                ".implicit coordinate spec (see "
                "mapping_torch._device_distances)")
        device = self.device if device is None else torch.device(device)
        key = (id(arr), self.dtype, str(device))
        hit = self._device.get(key)
        if hit is not None:
            self.stats["transfer_hits"] += 1
            self._device.move_to_end(key)
            return hit[1]
        self.stats["transfers"] += 1
        dev = torch.as_tensor(np.asarray(arr, dtype=self.np_dtype)).to(
            device)
        self._device[key] = (arr, dev)
        while len(self._device) > self._max_cached:
            self._device.popitem(last=False)
        return dev

    def clear_device_cache(self) -> None:
        self._device.clear()


def _default_devices(device: torch.device) -> list:
    """Every visible CUDA device for a CUDA ``device``, the first
    ``REPRO_TORCH_DEVICES`` of them when that is set above 0; ``[device]``
    otherwise."""
    if device.type != "cuda":
        return [device]
    n = torch.cuda.device_count()
    cap = int(os.environ.get("REPRO_TORCH_DEVICES", "0") or 0)
    if cap > 0:
        n = min(n, cap)
    return [torch.device("cuda", i) for i in range(n)]


_NUMPY = NumpyBackend()
# one TorchBackend per (dtype, device): engines and scoped ``use`` calls
# that ask for the same configuration share its device-resident cache
_TORCH: dict[tuple[str, str], TorchBackend] = {}


def get_backend(name: str, dtype: Optional[str] = None,
                device: Optional[str] = None):
    """Resolve a backend by name (``numpy`` | ``torch``).  The torch
    backend defaults to ``dtype="float64"`` on ``device="cuda"``."""
    if name == "numpy":
        return _NUMPY
    if name == "torch":
        key = (dtype or "float64", str(torch.device(device or "cuda")))
        be = _TORCH.get(key)
        if be is None:
            be = _TORCH[key] = TorchBackend(dtype=key[0], device=key[1])
        return be
    raise ValueError(f"unknown backend {name!r}; have: numpy, torch")


# None: no scope or set_backend chose one, so the default applies
_ACTIVE = None


def active():
    """The backend the mapping kernels currently dispatch to: the scoped
    or set one, else the torch backend on ``cuda`` (which raises
    :class:`BackendUnavailableError` when no GPU is visible)."""
    return _ACTIVE if _ACTIVE is not None else get_backend("torch")


def set_backend(name: str, dtype: Optional[str] = None,
                device: Optional[str] = None):
    """Set the process-wide active backend; returns the backend object."""
    global _ACTIVE
    _ACTIVE = get_backend(name, dtype, device)
    return _ACTIVE


@contextlib.contextmanager
def use(name, dtype: Optional[str] = None,
        device: Optional[str] = None) -> Iterator[object]:
    """Scoped backend switch::

        with backend.use("torch"):
            engine.place(request)        # device kernels, resident D

    ``name`` may also be a backend object returned by :func:`get_backend`.
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (name if not isinstance(name, str)
               else get_backend(name, dtype, device))
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev
