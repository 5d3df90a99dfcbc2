"""Device assignment for device meshes — `srun --distribution=TOFA` analogue.

On an MPI cluster the placement degree of freedom is *which node runs which
rank*.  On a device mesh the same degree of freedom is the order of the
device list the mesh is built from: logical mesh coordinate ``k`` (in
row-major flattening) executes on ``devices.flat[k]``.  Permuting the device
list is therefore exactly rank placement, and the program is unchanged —
only the physical realisation of each replica group moves.

This module computes that permutation, which
:func:`repro_torch.launch.mesh.make_tofa_mesh` turns into a ``DeviceMesh``
rank order:

  1. profile the step (``core.profiler``: a torch step on fake tensors, or
     HLO text) -> guest graph ``G`` over logical shard ids;
  2. model the physical fabric: :class:`GpuFabric`, H100 nodes of 8 GPUs
     behind NVSwitch joined by an InfiniBand fat tree; or :class:`Fabric`,
     the reference's TPU v5e pods (16x16 2D torus of chips over ICI;
     multi-pod adds a DCN dimension modelled as a high-cost link layer),
     kept to hold the port to the reference.  Both satisfy the engine's
     ``Topology`` protocol, so they plug straight into ``PlacementEngine``
     alongside ``TorusTopology`` and ``FatTreeTopology``;
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


# One InfiniBand fat-tree hop counts as the ratio of a GPU's NVLink 4 rate
# (450 GB/s each way) to its NDR NIC's (400 Gb/s, 50 GB/s), the H100 SXM5
# 80GB data sheet's (launch.roofline.LINK_BW / IB_BW), as DCN_HOP_COST
# models the DCN in the reference's Fabric.
IB_HOP_COST = 9.0
# GPUs in a node behind one NVSwitch (an HGX H100 board)
GPUS_PER_NODE = 8


@dataclasses.dataclass(frozen=True)
class GpuFabric:
    """H100 cluster: nodes of ``GPUS_PER_NODE`` GPUs behind one NVSwitch
    (one crossing costs 1), the nodes on an InfiniBand fat tree: the first
    hosts of the smallest k-ary :class:`~repro_torch.core.fattree.
    FatTreeTopology` that holds them, each fat-tree hop costing
    ``ib_hop_cost``.  Ranks are node-major, torchrun's order: GPU ``r``
    sits on node ``r // GPUS_PER_NODE``.

    Eq. 1 weighs at node granularity, since a node failure takes all its
    GPUs: a node is faulty (or straggling) as its worst GPU in ``p_f``
    (``straggler``), and that applies to each of its GPUs; across nodes
    the fat tree's endpoint-form weights scaled by ``ib_hop_cost``, within
    a node 1 plus each endpoint's penalty.  Satisfies the
    :class:`~repro_torch.core.engine.Topology` protocol."""

    n_gpus: int = 256
    ib_hop_cost: float = IB_HOP_COST

    @property
    def n_nodes(self) -> int:
        """Topology-protocol alias: one placement slot per GPU."""
        return self.n_gpus

    @property
    def n_hosts(self) -> int:
        return -(-self.n_gpus // GPUS_PER_NODE)

    def tree(self):
        from .fattree import FatTreeTopology
        k = 2
        while k ** 3 // 4 < self.n_hosts:
            k += 2
        return FatTreeTopology(k)

    def host_of(self) -> np.ndarray:
        """(n_gpus,) node of each GPU."""
        return np.arange(self.n_gpus) // GPUS_PER_NODE

    def _per_host(self, x) -> np.ndarray:
        """A per-GPU vector as each node's worst value, on the tree's hosts
        (the hosts past the cluster's at 0)."""
        out = np.zeros(self.tree().n_nodes)
        np.maximum.at(out, self.host_of(), np.asarray(x, dtype=np.float64))
        return out

    def _compose(self, tree_w: np.ndarray, intra: np.ndarray) -> np.ndarray:
        h = self.host_of()
        same = h[:, None] == h[None, :]
        w = np.where(same, intra, self.ib_hop_cost * tree_w[np.ix_(h, h)])
        np.fill_diagonal(w, 0.0)
        return w

    def hop_matrix(self) -> np.ndarray:
        """(n_gpus, n_gpus): 1 within a node, ``ib_hop_cost`` times the
        fat-tree hops (2 / 4 / 6) across nodes, 0 on the diagonal."""
        return self._compose(self.tree().hop_matrix(),
                             np.ones((self.n_gpus, self.n_gpus)))

    def weight_matrix(self, p_f: np.ndarray | None = None,
                      straggler: np.ndarray | None = None) -> np.ndarray:
        """Eq. 1 fault-aware weights at node granularity (class doc)."""
        if p_f is None and straggler is None:
            return self.hop_matrix()
        from .topology import FAULT_PENALTY
        hp = None if p_f is None else self._per_host(p_f)
        hs = None if straggler is None else self._per_host(straggler)
        tree_w = self.tree().weight_matrix(hp, straggler=hs)
        h = self.host_of()
        pen = np.zeros(self.n_gpus)
        if hp is not None:
            pen += FAULT_PENALTY * (hp[h] > 0)
        if hs is not None:
            pen += hs[h]
        return self._compose(tree_w, 1.0 + pen[:, None] + pen[None, :])

    def coords_array(self) -> np.ndarray:
        """(n_gpus, 4) coordinates: the node's (pod, edge, host) in the fat
        tree, then the GPU's slot in its node."""
        slot = np.arange(self.n_gpus) % GPUS_PER_NODE
        return np.concatenate([self.tree().coords_array()[self.host_of()],
                               slot[:, None]], axis=1)


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
    fabric,
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
    if comm.n > fabric.n_nodes:
        raise ValueError(
            f"comm graph has {comm.n} shards but fabric has only "
            f"{fabric.n_nodes} chips")
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
    fabric,
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
