"""Node registry — slurmd-side state for every compute node.

Mirrors the information the paper's *FATT* plugin reads from the topology
file (node id + torus coordinates) and the state that *NodeState* /
*Fault Aware Slurmctld* maintain per node (up/down, outage statistics).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.state import NodeHealth
from repro_torch.core.topology import TorusTopology


class NodeState(enum.Enum):
    UP = "up"
    DOWN = "down"
    DRAINED = "drained"   # administratively removed (beyond paper: elastic)
    DEGRADED = "degraded"  # allocatable but flaky: elevated outage estimate

    @property
    def health(self) -> NodeHealth:
        """The :class:`~repro_torch.core.state.NodeHealth` lifecycle code this
        administrative state maps onto."""
        return _HEALTH[self]

    @property
    def allocatable(self) -> bool:
        return self in (NodeState.UP, NodeState.DEGRADED)


_HEALTH = {
    NodeState.UP: NodeHealth.UP,
    NodeState.DEGRADED: NodeHealth.DEGRADED,
    NodeState.DRAINED: NodeHealth.DRAINED,
    NodeState.DOWN: NodeHealth.DOWN,
}


@dataclasses.dataclass
class NodeInfo:
    node_id: int
    coords: tuple[int, ...]
    state: NodeState = NodeState.UP
    true_outage_p: float = 0.0      # ground truth used by fault injection
    slowdown: float = 0.0           # straggler factor (beyond paper)


class NodeRegistry:
    """All nodes of the platform, keyed by id (id order == Slurm order)."""

    def __init__(self, topo: TorusTopology):
        self.topo = topo
        self.nodes = [NodeInfo(i, topo.coords(i)) for i in range(topo.n_nodes)]

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, i: int) -> NodeInfo:
        return self.nodes[i]

    def set_outage_probabilities(self, ids, p: float) -> None:
        for i in ids:
            self.nodes[int(i)].true_outage_p = p

    def true_outage_vector(self) -> np.ndarray:
        return np.array([n.true_outage_p for n in self.nodes])

    def up_ids(self) -> np.ndarray:
        return np.array([n.node_id for n in self.nodes
                         if n.state == NodeState.UP])

    def allocatable_ids(self) -> np.ndarray:
        """Nodes placements may use: UP or DEGRADED, in id order."""
        return np.array([n.node_id for n in self.nodes
                         if n.state.allocatable], dtype=np.int64)

    def health_codes(self) -> np.ndarray:
        """(n,) int8 :class:`~repro_torch.core.state.NodeHealth` codes — the
        lifecycle vector a :class:`~repro_torch.core.state.ClusterState`
        snapshot is minted from."""
        return np.array([int(n.state.health) for n in self.nodes],
                        dtype=np.int8)

    def mark(self, ids, state: NodeState) -> None:
        for i in ids:
            self.nodes[int(i)].state = state

    def topology_file(self) -> str:
        """The FATT plugin's input format: 'id x y z' per line."""
        return "\n".join(
            f"{n.node_id} " + " ".join(str(c) for c in n.coords)
            for n in self.nodes)

    @classmethod
    def from_topology_file(cls, text: str, dims: tuple[int, ...]
                           ) -> "NodeRegistry":
        topo = TorusTopology(dims)
        reg = cls(topo)
        for line in text.strip().splitlines():
            parts = line.split()
            nid, coords = int(parts[0]), tuple(int(c) for c in parts[1:])
            assert reg.nodes[nid].coords == coords, "topology file mismatch"
        return reg
