"""Placement core of the port: engine, policies, mapping, topologies."""
from repro_torch.core.comm_graph import CommGraph
from repro_torch.core.state import ClusterState, NodeHealth, StateDiff
from repro_torch.core.topology import TorusTopology, find_consecutive_healthy
from repro_torch.core.fattree import FatTreeTopology
from repro_torch.core.mapping import hop_bytes, avg_dilation, map_graph
from repro_torch.core.engine import (PlacementEngine, PlacementPlan,
                                     PlacementRequest, default_engine)
from repro_torch.core.policies import (PlacementPolicy, PolicyContext,
                                       PolicyOutput, available_policies,
                                       get_policy, register_policy)
from repro_torch.core.tofa import tofa_place, place, PlacementResult, POLICIES
