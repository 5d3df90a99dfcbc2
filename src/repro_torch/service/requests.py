"""Typed requests and replies of the online placement service.

A :class:`ServiceRequest` is what a serving frontend hands the placement
service: *what* needs nodes (an inference replica set with its KV-cache
shards, or a small elastic job), *how urgently* (an :class:`SLOClass`
lane plus an absolute admission ``deadline``), and *for how long* (the
lease's ``hold_time``).  The service answers with a mutable
:class:`ServiceReply` that tracks the request through its lifecycle
(queued → placed → completed, with shed / rejected / preempted exits).

**KV-shard affinity.**  A replica request models the communication
structure of one decode engine plus ``shards_per_replica`` KV-cache
shards: the engine streams attention reads/writes to every one of its
shards each decode round (the heavy, affinity-defining edges), shards
exchange a light sequence-parallel ring, and replica engines share a
light session-sync all-reduce.  Shard traffic volume is derived from the
model's *cache schema* (:func:`repro_torch.serve.kvcache.cache_schema`,
whose byte counts equal the reference package's for every family) — so
placement pressure scales with the real cache footprint of the
architecture being served.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Optional

import numpy as np

from repro_torch.core.comm_graph import CommGraph
from repro_torch.serve.kvcache import cache_schema
from repro_torch.workloads.patterns import Workload

_req_ids = itertools.count(1)


class SLOClass(enum.IntEnum):
    """Priority lane of a request; lower value drains first.

    ``INTERACTIVE`` may preempt ``BEST_EFFORT`` leases under pressure;
    ``BEST_EFFORT`` is the preemption victim pool and is never allowed to
    delay the other lanes."""

    INTERACTIVE = 0
    STANDARD = 1
    BEST_EFFORT = 2


# ---------------------------------------------------------------------------
# KV-cache shard sizing
# ---------------------------------------------------------------------------

def _schema_bytes(schema, default_itemsize: int = 2) -> float:
    """Total bytes of a ParamDef tree (bf16 default, pinned dtypes kept)."""
    total = 0.0
    for node in schema.values():
        if isinstance(node, dict):
            total += _schema_bytes(node, default_itemsize)
            continue
        size = float(np.prod(node.shape))
        itemsize = (default_itemsize if node.dtype is None
                    else node.dtype.itemsize)
        total += size * itemsize
    return total


def _analytic_cache_bytes(cfg, batch: int, max_seq: int,
                          itemsize: int = 2) -> float:
    """Cache footprint from config arithmetic alone.

    Mirrors the per-family shape formulas of
    :func:`repro_torch.serve.kvcache.cache_schema` for the attention and SSM
    families; hybrid/vlm/encdec splits are approximated by their dominant
    term.  :func:`kv_shard_bytes` uses the exact schema; this is the
    reference package's fallback, kept so that the two can be compared."""
    L, B, S = cfg.n_layers, batch, max_seq
    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "encdec"):
        if getattr(cfg, "attn_type", "gqa") == "mla" and cfg.mla:
            per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            return float(L * B * S * per_tok * itemsize)
        hd = cfg.head_dim_
        return float(2 * L * B * cfg.n_kv_heads * S * hd * itemsize)
    # ssm / hybrid: O(1) in sequence length
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    conv = L * B * (s.d_conv - 1) * conv_ch * itemsize
    state = L * B * H * s.head_dim * s.d_state * 4        # pinned float32
    return float(conv + state)


def kv_shard_bytes(cfg, batch: int, max_seq: int,
                   shards: int = 1) -> float:
    """Bytes per KV-cache shard for serving ``cfg`` at (batch, max_seq).

    Uses the exact :func:`repro_torch.serve.kvcache.cache_schema` ParamDef
    tree (bf16 serving dtype, pinned float32 SSM states honored).  The
    cache is assumed evenly sharded."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return _schema_bytes(cache_schema(cfg, batch, max_seq)) / shards


# ---------------------------------------------------------------------------
# request payloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Shape of one replica set — kept on the request so elastic resize
    can mint the communication graph for any replica count.

    ``shard_bytes`` is the per-shard cache footprint; per-round traffic
    is derived from it: the decode engine touches ``rw_fraction`` of
    every shard each round (attention reads dominate), shards exchange a
    tenth of that on the sequence-parallel ring, and replica engines
    all-reduce ``sync_bytes`` of session state every tenth round."""

    shards_per_replica: int
    shard_bytes: float
    rw_fraction: float = 0.05
    sync_bytes: float = 64e3
    rounds: int = 50
    flops_per_rank: float = 5e6
    arch: str = "generic"

    @property
    def ranks_per_replica(self) -> int:
        return 1 + self.shards_per_replica

    def workload(self, n_replicas: int) -> Workload:
        """Communication graph of ``n_replicas`` replicas of this shape.

        Rank layout: replica ``i`` owns the contiguous block
        ``[i * ranks_per_replica, (i+1) * ranks_per_replica)`` — engine
        rank first, then its shards — so resize can grow/shrink whole
        trailing blocks."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        rpr = self.ranks_per_replica
        n = n_replicas * rpr
        g = CommGraph(n)
        kv_bytes = self.rw_fraction * self.shard_bytes
        engines = []
        for i in range(n_replicas):
            eng = i * rpr
            engines.append(eng)
            shards = list(range(eng + 1, eng + rpr))
            for s in shards:
                g.add_p2p(eng, s, self.rounds * kv_bytes, self.rounds)
            # light sequence-parallel ring between a replica's shards
            for a, b in zip(shards, shards[1:] + shards[:1]):
                if a != b:
                    g.add_p2p(a, b, self.rounds * kv_bytes * 0.1,
                              self.rounds)
        if len(engines) > 1:
            g.add_all_reduce(engines, self.sync_bytes,
                             repeats=self.rounds / 10)
        return Workload(f"serve-{self.arch}x{n_replicas}", g,
                        self.flops_per_rank, self.rounds, "serve")


@dataclasses.dataclass(frozen=True)
class ServiceRequest:
    """One unit of serving work submitted to the placement service."""

    workload: Workload
    slo: SLOClass = SLOClass.STANDARD
    deadline: float = math.inf       # absolute sim seconds; admission bound
    submit_time: float = 0.0
    hold_time: Optional[float] = None    # lease length; None = model runtime
    policy: Optional[str] = None         # None = service default
    replica_spec: Optional[ReplicaSpec] = None   # resizable replica sets
    n_replicas: int = 1
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))

    def __post_init__(self):
        if self.deadline < self.submit_time:
            raise ValueError(
                f"deadline {self.deadline} precedes submit_time "
                f"{self.submit_time}")
        if self.hold_time is not None and self.hold_time <= 0:
            raise ValueError(f"hold_time must be > 0, got {self.hold_time}")

    @property
    def n_ranks(self) -> int:
        return self.workload.n_ranks

    @property
    def ranks_per_replica(self) -> int:
        if self.replica_spec is not None:
            return self.replica_spec.ranks_per_replica
        return max(1, self.n_ranks // max(1, self.n_replicas))

    def label(self) -> str:
        return f"{self.workload.name}#{self.req_id}"


def replica_request(cfg=None, *, n_replicas: int = 2,
                    shards_per_replica: int = 3,
                    batch: int = 8, max_seq: int = 4096,
                    shard_bytes: Optional[float] = None,
                    slo: SLOClass = SLOClass.INTERACTIVE,
                    deadline: float = math.inf,
                    submit_time: float = 0.0,
                    hold_time: Optional[float] = None,
                    policy: Optional[str] = None,
                    **spec_kw) -> ServiceRequest:
    """Build a resizable inference-replica request.

    ``cfg`` is a :class:`~repro_torch.configs.base.ModelConfig` whose cache
    schema sizes the shards; pass ``shard_bytes`` directly to skip model
    configs entirely (the benchmark does)."""
    if shard_bytes is None:
        if cfg is None:
            raise ValueError("pass a ModelConfig or shard_bytes")
        shard_bytes = kv_shard_bytes(cfg, batch, max_seq,
                                     shards=shards_per_replica)
        spec_kw.setdefault("arch", getattr(cfg, "name", "model"))
    spec = ReplicaSpec(shards_per_replica=shards_per_replica,
                       shard_bytes=shard_bytes, **spec_kw)
    return ServiceRequest(workload=spec.workload(n_replicas), slo=slo,
                          deadline=deadline, submit_time=submit_time,
                          hold_time=hold_time, policy=policy,
                          replica_spec=spec, n_replicas=n_replicas)


def elastic_request(workload: Workload, *,
                    slo: SLOClass = SLOClass.BEST_EFFORT,
                    deadline: float = math.inf,
                    submit_time: float = 0.0,
                    hold_time: Optional[float] = None,
                    policy: Optional[str] = None) -> ServiceRequest:
    """Wrap a batch-style :class:`Workload` as a (default best-effort)
    service request — the small elastic jobs that ride alongside serving
    traffic and form the preemption victim pool."""
    return ServiceRequest(workload=workload, slo=slo, deadline=deadline,
                          submit_time=submit_time, hold_time=hold_time,
                          policy=policy)


# ---------------------------------------------------------------------------
# replies
# ---------------------------------------------------------------------------

#: terminal reply states (no further transitions)
TERMINAL = frozenset(("completed", "shed", "rejected", "failed"))


@dataclasses.dataclass
class ServiceReply:
    """Mutable lifecycle record the service keeps per request.

    ``status`` walks ``pending -> queued -> placed -> completed`` in the
    happy path; ``shed`` (deadline passed in queue), ``rejected`` (queue
    full), ``failed`` (survivors cannot hold the job) and transient
    ``preempted`` (victim of an SLO preemption, back in its lane) mark
    the exits.  Times are simulated seconds; ``-1`` = not reached."""

    req_id: int
    slo: SLOClass
    status: str = "pending"
    submit_time: float = 0.0
    placed_time: float = -1.0
    finish_time: float = -1.0
    preemptions: int = 0
    replacements: int = 0
    nodes: Optional[np.ndarray] = None

    @property
    def admission_latency(self) -> float:
        """Queue entry to first placement (simulated seconds; -1 if never
        placed)."""
        if self.placed_time < 0:
            return -1.0
        return self.placed_time - self.submit_time

    @property
    def completion_time(self) -> float:
        """Sojourn: submit to completion (queue wait, preemptions and
        re-placement restarts included; -1 if not completed)."""
        if self.finish_time < 0:
            return -1.0
        return self.finish_time - self.submit_time

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL


__all__ = ["SLOClass", "ReplicaSpec", "ServiceRequest", "ServiceReply",
           "replica_request", "elastic_request", "kv_shard_bytes",
           "TERMINAL"]
