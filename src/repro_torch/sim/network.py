"""Network performance models — the SimGrid platform analogue.

:class:`TorusNetwork` is the flow-level torus model below;
:class:`HopNetwork` is a distance-level fallback that makes any
``Topology`` implementation (fat-tree, dragonfly) a simulation host.

The paper simulates an 8x8x8 torus in SimGrid with 6 Gflops nodes, 10 Gbps
/ 1 usec links, and emulates a failed node by setting the capacity of all
its links to zero (killing any transmission routed through it).  This module
reproduces that platform at flow level:

* traffic between placed ranks follows the same dimension-ordered routes the
  topology graph uses (the platform description "lists the route for each
  pair of nodes ... matches exactly the topology assumed for deriving the
  mapping");
* per-link loads are accumulated over routes; the bandwidth term of a
  communication round is the *bottleneck* link serialization (max over
  links), the latency term charges per-message hop latency on the heaviest
  pair;
* a failed node zeroes all of its links: any job whose traffic or endpoints
  touch it aborts, exactly like SimGrid's zero-capacity variation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.comm_graph import CommGraph
from repro_torch.core.topology import TorusTopology

GBPS = 1e9 / 8.0  # bytes/sec per Gbit/s


@dataclasses.dataclass
class TorusNetwork:
    topo: TorusTopology
    link_bandwidth: float = 10 * GBPS   # paper: 10 Gbps
    link_latency: float = 1e-6          # paper: 1 usec
    node_flops: float = 6e9             # paper: 6 Gflops

    def __post_init__(self):
        self._route_cache: dict[tuple[int, int], list] = {}

    def _route(self, u: int, v: int):
        key = (u, v)
        r = self._route_cache.get(key)
        if r is None:
            r = self.topo.route(u, v)
            self._route_cache[key] = r
        return r

    # ------------------------------------------------------------- loads
    def link_loads(self, comm: CommGraph, placement: np.ndarray
                   ) -> dict[tuple[int, int], float]:
        """Bytes per directed physical link, routing G_v over the placement."""
        loads: dict[tuple[int, int], float] = {}
        n = comm.n
        G = comm.G_v
        p = np.asarray(placement)
        for i in range(n):
            for j in range(i + 1, n):
                b = G[i, j]
                if b <= 0:
                    continue
                # symmetric convention: G[i,j] already holds both directions;
                # split evenly over the two directed routes
                for (u, v), frac in (((int(p[i]), int(p[j])), 0.5),
                                     ((int(p[j]), int(p[i])), 0.5)):
                    for link in self._route(u, v):
                        key = (link.src, link.dst)
                        loads[key] = loads.get(key, 0.0) + b * frac
        return loads

    def touches_failed(self, comm: CommGraph, placement: np.ndarray,
                       failed: np.ndarray) -> bool:
        """True if any endpoint or any routed hop touches a failed node."""
        failed_set = set(int(f) for f in np.asarray(failed).ravel())
        if not failed_set:
            return False
        p = np.asarray(placement)
        if any(int(x) in failed_set for x in p):
            return True
        n = comm.n
        G = comm.G_v
        for i in range(n):
            for j in range(i + 1, n):
                if G[i, j] <= 0:
                    continue
                for u, v in ((int(p[i]), int(p[j])), (int(p[j]), int(p[i]))):
                    for link in self._route(u, v):
                        if link.dst in failed_set or link.src in failed_set:
                            return True
        return False

    # -------------------------------------------------------------- times
    def comm_time(self, comm: CommGraph, placement: np.ndarray) -> float:
        """Time to drain the job's whole communication volume.

        bandwidth term: bottleneck link serialization (congestion);
        latency term:   per-message hop latency of the chattiest pair.
        """
        loads = self.link_loads(comm, placement)
        t_bw = max(loads.values()) / self.link_bandwidth if loads else 0.0
        p = np.asarray(placement)
        t_lat = 0.0
        n = comm.n
        for i in range(n):
            for j in range(i + 1, n):
                m = comm.G_m[i, j]
                if m <= 0:
                    continue
                hops = len(self._route(int(p[i]), int(p[j])))
                t_lat = max(t_lat, m * hops * self.link_latency)
        return t_bw + t_lat

    def compute_time(self, flops_per_rank: float, rounds: float) -> float:
        return flops_per_rank * rounds / self.node_flops


@dataclasses.dataclass
class HopNetwork:
    """Distance-level network model for any :class:`~repro_torch.core.engine.
    Topology` implementation (fat-tree, dragonfly, ...).

    Where :class:`TorusNetwork` routes every flow over explicit links and
    takes the bottleneck link as the bandwidth term, ``HopNetwork`` only
    has the topology's hop-distance matrix to work with.  It charges:

    * bandwidth: total *byte-hops* (``sum G_v[i,j] * hops(p_i, p_j)``)
      spread over the job's ``n`` injection links — placement-sensitive
      (proportional to the hop-bytes objective the mappers minimise) and
      equal to the torus model's serialization in the uniform-load limit;
    * latency: per-message hop latency of the chattiest pair, as in
      :class:`TorusNetwork`.

    The fault model is *endpoint form*, matching
    :meth:`~repro_torch.core.fattree.FatTreeTopology.weight_matrix`: multi-path
    fabrics route around interior failures, so only a failed node that is
    itself a job endpoint aborts the job.
    """

    topo: "object"                      # any Topology (hop_matrix + n_nodes)
    link_bandwidth: float = 10 * GBPS
    link_latency: float = 1e-6
    node_flops: float = 6e9

    def __post_init__(self):
        self._hops: np.ndarray | None = None

    def hop_matrix(self) -> np.ndarray:
        if self._hops is None:
            self._hops = self.topo.hop_matrix()
        return self._hops

    def touches_failed(self, comm: CommGraph, placement: np.ndarray,
                       failed: np.ndarray) -> bool:
        """Endpoint fault form: abort iff a failed node hosts a process."""
        failed = np.asarray(failed).ravel()
        if not failed.size:
            return False
        return bool(np.isin(np.asarray(placement), failed).any())

    def comm_time(self, comm: CommGraph, placement: np.ndarray) -> float:
        p = np.asarray(placement)
        D = self.hop_matrix()
        hops = D[np.ix_(p, p)]
        byte_hops = float((comm.G_v * hops).sum()) / 2.0  # symmetric G
        t_bw = byte_hops / (self.link_bandwidth * max(comm.n, 1))
        t_lat = float((comm.G_m * hops).max()) * self.link_latency
        return t_bw + t_lat

    def compute_time(self, flops_per_rank: float, rounds: float) -> float:
        return flops_per_rank * rounds / self.node_flops


def network_for(topo, **kw):
    """Pick the highest-fidelity in-tree network model for a topology:
    flow-level :class:`TorusNetwork` for tori, distance-level
    :class:`HopNetwork` for everything else."""
    if isinstance(topo, TorusTopology):
        return TorusNetwork(topo, **kw)
    return HopNetwork(topo, **kw)
