"""Online fault-aware placement service for serving traffic.

The batch path (:mod:`repro_torch.cluster.scheduler`,
:mod:`repro_torch.sim.clustersim`) places MPI jobs once per submission;
this package stands up the serving counterpart: a long-running,
event-driven service that admits a continuous stream of placement
requests — inference replicas with their KV-cache shards, plus small
elastic jobs — and places them on the same fault-aware topology with
interactive latency.  Its engine places on the card unless the caller
asks for the CPU (``PlacementService(topo, device="cpu")``).

Modules:

* :mod:`~repro_torch.service.requests` — typed :class:`ServiceRequest` /
  :class:`ServiceReply` with SLO class, deadline, replica structure, and
  KV-shard affinity derived from :mod:`repro_torch.serve.kvcache` cache
  schemas.
* :mod:`~repro_torch.service.queue` — SLO-aware admission: per-class priority
  lanes, deadline (EDF) ordering, load shedding.
* :mod:`~repro_torch.service.service` — the event loop: one versioned
  :class:`~repro_torch.core.state.ClusterState`, batched ``place_many`` drain
  ticks, heartbeat/failure-driven re-placement, preemption, elastic
  resize.
* :mod:`~repro_torch.service.metrics` — latency histograms, queue depth,
  placements/sec, preemption/re-placement counters (BENCH-shaped JSON).
"""
from repro_torch.service.metrics import LatencyHistogram, ServiceMetrics
from repro_torch.service.queue import AdmissionQueue
from repro_torch.service.requests import (ReplicaSpec, ServiceReply,
                                          ServiceRequest, SLOClass,
                                          elastic_request, kv_shard_bytes,
                                          replica_request)
from repro_torch.service.service import PlacementService, ServiceResult

__all__ = [
    "SLOClass", "ServiceRequest", "ServiceReply", "ReplicaSpec",
    "replica_request", "elastic_request", "kv_shard_bytes",
    "AdmissionQueue", "ServiceMetrics", "LatencyHistogram",
    "PlacementService", "ServiceResult",
]
