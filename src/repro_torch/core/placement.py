"""Device assignment for device meshes — `srun --distribution=TOFA` analogue.

On an MPI cluster the placement degree of freedom is *which node runs which
rank*.  On a device mesh the same degree of freedom is the order of the
device list the mesh is built from: logical mesh coordinate ``k`` (in
row-major flattening) executes on ``devices.flat[k]``.  Permuting the device
list is therefore exactly rank placement, and the program is unchanged —
only the physical realisation of each replica group moves.

This module computes that permutation (the reference package's copy feeds
it to ``jax.sharding.Mesh``; the port does not construct meshes yet):

  1. profile the compiled step (``core.profiler``) -> guest graph ``G`` over
     logical shard ids;
  2. model the physical fabric (:class:`Fabric`) — v5e pod = 16x16 2D torus
     of chips over ICI; multi-pod adds a DCN dimension modelled as a
     high-cost link layer.  ``Fabric`` satisfies the engine's ``Topology``
     protocol, so it plugs straight into ``PlacementEngine`` alongside
     ``TorusTopology`` and ``FatTreeTopology``;
  3. health feed (``cluster.heartbeat``) -> per-chip outage probabilities;
  4. the requested registry policy (default TOFA) maps logical shards onto
     physical chips through the engine — the caller's ``engine``, else the
     shared :func:`~repro_torch.core.engine.default_engine` on ``device``
     (``cuda`` when omitted, which raises
     :class:`~repro_torch.core.backend.BackendUnavailableError` without a
     GPU).

``placement[k] = physical chip id of logical shard k``; mesh construction
inverts this into a device reordering.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from .comm_graph import CommGraph
from .engine import (PlacementEngine, PlacementPlan, PlacementRequest,
                     default_engine)
from .mapping import hop_bytes

# DCN (inter-pod) links are ~an order of magnitude slower than ICI; in the
# hop-cost model one pod-crossing counts as this many ICI hops.
DCN_HOP_COST = 10.0


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Physical fabric: per-pod 2D/3D torus of chips (+ optional pod axis).

    Satisfies the :class:`~repro_torch.core.engine.Topology` protocol.
    """

    pod_dims: tuple[int, ...] = (16, 16)   # v5e pod: 16x16 ICI torus
    n_pods: int = 1
    dcn_hop_cost: float = DCN_HOP_COST

    @property
    def chips_per_pod(self) -> int:
        return int(np.prod(self.pod_dims))

    @property
    def n_chips(self) -> int:
        return self.chips_per_pod * self.n_pods

    @property
    def n_nodes(self) -> int:
        """Topology-protocol alias: one placement slot per chip."""
        return self.n_chips

    def torus(self):
        from .topology import TorusTopology
        return TorusTopology(self.pod_dims)

    def hop_matrix(self) -> np.ndarray:
        """(n_chips, n_chips) hop costs: intra-pod ICI hops; pod crossings
        add ``dcn_hop_cost`` (chips first grouped by pod, row-major)."""
        t = self.torus()
        intra = t.hop_matrix()
        n, P = self.chips_per_pod, self.n_pods
        full = np.empty((n * P, n * P))
        for a in range(P):
            for b in range(P):
                blk = intra.copy()
                if a != b:
                    blk = blk + self.dcn_hop_cost
                full[a * n:(a + 1) * n, b * n:(b + 1) * n] = blk
        return full

    def weight_matrix(self, p_f: np.ndarray | None = None,
                      straggler: np.ndarray | None = None) -> np.ndarray:
        """Eq. 1 fault-aware weights on the multi-pod fabric."""
        if p_f is None and straggler is None:
            return self.hop_matrix()
        n, P = self.chips_per_pod, self.n_pods
        p_f = np.zeros(self.n_chips) if p_f is None else np.asarray(p_f)
        t = self.torus()
        full = np.empty((self.n_chips, self.n_chips))
        for a in range(P):
            for b in range(P):
                if a == b:
                    s = straggler[a * n:(a + 1) * n] if straggler is not None else None
                    blk = t.weight_matrix(p_f[a * n:(a + 1) * n], straggler=s)
                else:
                    # conservative cross-pod model: ICI hops to/from the pod
                    # egress + DCN cost; fault penalty applies if either
                    # endpoint chip is unhealthy.
                    blk = t.hop_matrix() + self.dcn_hop_cost
                    fa = p_f[a * n:(a + 1) * n] > 0
                    fb = p_f[b * n:(b + 1) * n] > 0
                    blk = blk + 100.0 * (fa[:, None] | fb[None, :])
                full[a * n:(a + 1) * n, b * n:(b + 1) * n] = blk
        return full

    def coords_array(self) -> np.ndarray:
        """(n_chips, ndim+1) coordinates: (pod, *torus coords)."""
        t = self.torus().coords_array()
        out = []
        for pod in range(self.n_pods):
            pod_col = np.full((t.shape[0], 1), pod)
            out.append(np.concatenate([pod_col, t], axis=1))
        return np.concatenate(out, axis=0)


@dataclasses.dataclass
class DeviceAssignment:
    """Result of a placement policy applied to a mesh."""

    permutation: np.ndarray     # perm[k] = device index for logical shard k
    plan: PlacementPlan
    hop_bytes_linear: float     # baseline (identity assignment) cost
    hop_bytes_placed: float     # cost under this assignment

    @property
    def result(self) -> PlacementPlan:
        """Legacy alias kept from the pre-engine API."""
        return self.plan

    @property
    def improvement(self) -> float:
        if self.hop_bytes_linear <= 0:
            return 0.0
        return 1.0 - self.hop_bytes_placed / self.hop_bytes_linear


def assign_devices(
    comm: CommGraph,
    fabric: Fabric,
    policy: str = "tofa",
    p_f: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
    engine: Optional[PlacementEngine] = None,
    state=None,
    device: Optional[str] = None,
) -> DeviceAssignment:
    """Compute a device permutation for ``Mesh`` construction.

    The returned permutation satisfies: logical shard k should run on
    physical chip ``permutation[k]``: index a device list ordered by
    physical position with it, and build the mesh from the result.
    ``device`` is where the shared default engine places when no
    ``engine`` is given (``cuda`` when omitted).
    """
    if comm.n > fabric.n_chips:
        raise ValueError(
            f"comm graph has {comm.n} shards but fabric has only "
            f"{fabric.n_chips} chips")
    # comm.n < n_chips is fine: the job occupies a subset of the fabric
    # (placement[k] is then a chip id, not a permutation of 0..n-1)
    engine = engine if engine is not None else default_engine(device)
    # ``state`` (a ClusterState over chips) is the first-class health
    # input; the ``p_f`` kwarg remains as the engine-level shim does
    req = (PlacementRequest(comm=comm, topology=fabric, state=state)
           if state is not None
           else PlacementRequest(comm=comm, topology=fabric, p_f=p_f))
    plan = engine.place(req, policy=policy, rng=rng)
    hops = engine.hops(fabric)
    identity = np.arange(comm.n)
    # both scores on the engine's backend and device, as its plans are
    with engine._backend_ctx():
        linear = hop_bytes(comm.G_v, hops, identity)
        placed = hop_bytes(comm.G_v, hops, plan.placement)
    return DeviceAssignment(
        permutation=plan.placement.copy(),
        plan=plan,
        hop_bytes_linear=linear,
        hop_bytes_placed=placed,
    )


def compare_policies(
    comm: CommGraph,
    fabric: Fabric,
    policies: Optional[Iterable[str]] = None,
    p_f: np.ndarray | None = None,
    seed: int = 0,
    engine: Optional[PlacementEngine] = None,
    state=None,
    device: Optional[str] = None,
) -> dict:
    """Hop-bytes and dilation per policy — the placement-quality report.

    ``policies`` defaults to every registered policy.  All policies share
    one engine, so the fabric's hop/weight matrices are derived once.
    ``device`` is where the shared default engine places when no
    ``engine`` is given (``cuda`` when omitted).
    """
    engine = engine if engine is not None else default_engine(device)
    req = (PlacementRequest(comm=comm, topology=fabric, state=state,
                            seed=seed)
           if state is not None
           else PlacementRequest(comm=comm, topology=fabric, p_f=p_f,
                                 seed=seed))
    plans = engine.compare(req, policies=policies)
    return {pol: {
        "hop_bytes": plan.hop_bytes,
        "avg_dilation": plan.avg_dilation,
        "faulty_nodes_used": plan.faulty_nodes_used,
    } for pol, plan in plans.items()}
