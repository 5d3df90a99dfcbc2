"""Legacy TOFA entry points — thin shims over the PlacementEngine.

The algorithm itself (paper Listing 1.1) lives in
:mod:`repro_torch.core.policies.tofa`; the string-dispatched policy set
lives in the registry (:mod:`repro_torch.core.policies`).  ``tofa_place``
/ ``place`` are kept so pre-engine callers continue to work unchanged —
they build a :class:`~repro_torch.core.engine.PlacementRequest`, run the
shared :func:`~repro_torch.core.engine.default_engine` (on ``cuda``;
without a GPU they raise), and down-convert the resulting
:class:`~repro_torch.core.engine.PlacementPlan` to the historical
:class:`PlacementResult`.  New code should use the engine API directly.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from .comm_graph import CommGraph
from .engine import PlacementRequest, default_engine
from .policies import available_policies
from .policies.tofa import FAULT_BLOCK  # noqa: F401  (legacy re-export)
from .topology import TorusTopology


@dataclasses.dataclass
class PlacementResult:
    """T = <process id, node id> plus quality diagnostics (legacy view)."""

    placement: np.ndarray          # (n_procs,) node ids
    policy: str
    used_consecutive_window: bool  # TOFA step 10 succeeded?
    hop_bytes: float               # dilation-volume under healthy hop metric
    faulty_nodes_used: int         # processes placed on p_f > 0 nodes

    def as_pairs(self) -> list[tuple[int, int]]:
        return [(i, int(nid)) for i, nid in enumerate(self.placement)]


def _deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.tofa.{name}() is deprecated; use "
        "repro_torch.core.engine.PlacementEngine with a PlacementRequest",
        DeprecationWarning, stacklevel=3)


def tofa_place(
    comm: CommGraph,
    topo: TorusTopology,
    p_f: np.ndarray | None = None,
    *,
    metric: str = "volume",
    rng: np.random.Generator | None = None,
    straggler: np.ndarray | None = None,
) -> PlacementResult:
    """Run TOFA (Listing 1.1) and return the placement with diagnostics."""
    _deprecated("tofa_place")
    req = PlacementRequest(comm=comm, topology=topo, p_f=p_f,
                           straggler=straggler, metric=metric)
    return default_engine().place(req, policy="tofa", rng=rng).to_result()


def place(
    policy: str,
    comm: CommGraph,
    topo: TorusTopology,
    p_f: np.ndarray | None = None,
    *,
    metric: str = "volume",
    rng: np.random.Generator | None = None,
    available: np.ndarray | None = None,
) -> PlacementResult:
    """Registry-dispatched placement: 'linear' (default-slurm), 'random',
    'greedy', 'tofa', and 'topo' (topology-aware but fault-blind — the
    Section 5.1 Scotch run), plus any third-party registered policy.

    ``available`` restricts every policy to allocatable nodes (Slurm never
    schedules onto DOWN/DRAINED nodes, independent of fault-awareness).
    """
    _deprecated("place")
    req = PlacementRequest(comm=comm, topology=topo, p_f=p_f,
                           available=available, metric=metric)
    return default_engine().place(req, policy=policy, rng=rng).to_result()


#: Legacy policy tuple — now sourced from the registry.
POLICIES = available_policies()
