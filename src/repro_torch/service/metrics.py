"""Service-side observability: latency histograms + lifecycle counters.

:class:`ServiceMetrics` is what the storm benchmark and the service's
``run()`` result report from.  It keeps simulated-time admission and
completion latencies in :class:`LatencyHistogram` (log-spaced buckets for
the JSON row, raw samples for exact percentiles), wall-clock placement
cost, queue-depth samples per drain tick, and counters for every
lifecycle transition (placed, shed, rejected, preempted, re-placed,
resized...).  :meth:`ServiceMetrics.to_row` flattens everything into the
flat-dict shape the ``BENCH_*.json`` trajectory files use.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


class LatencyHistogram:
    """Log-spaced latency histogram with exact percentiles.

    Buckets cover [lo, hi) multiplicatively (plus underflow/overflow
    edges) for a compact JSON export; the raw samples are also kept so
    p50/p99 are exact rather than bucket-interpolated — sample counts
    here are thousands, not billions."""

    def __init__(self, lo: float = 1e-3, hi: float = 1e4,
                 n_buckets: int = 36):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
        self.edges = np.concatenate(
            ([0.0], np.geomspace(lo, hi, n_buckets + 1), [math.inf]))
        self.counts = np.zeros(len(self.edges) - 1, dtype=np.int64)
        self._samples: list[float] = []

    def observe(self, value: float) -> None:
        if value < 0:
            raise ValueError(f"latency must be >= 0, got {value}")
        self.counts[np.searchsorted(self.edges, value, side="right") - 1] += 1
        self._samples.append(float(value))

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, q: float) -> float:
        """Exact q-th percentile of the observed samples (-1 when empty)."""
        if not self._samples:
            return -1.0
        return float(np.percentile(self._samples, q))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def mean(self) -> float:
        return float(np.mean(self._samples)) if self._samples else -1.0

    @property
    def max(self) -> float:
        return float(np.max(self._samples)) if self._samples else -1.0

    def to_dict(self) -> dict:
        nz = np.flatnonzero(self.counts)
        return {
            "n": len(self),
            "p50": self.p50, "p99": self.p99,
            "mean": self.mean, "max": self.max,
            "buckets": {f"{self.edges[i]:.3g}": int(self.counts[i])
                        for i in nz},
        }


@dataclasses.dataclass
class ServiceMetrics:
    """Counters and latency distributions of one service run."""

    submitted: int = 0
    placed: int = 0            # placement events (re-placements excluded)
    completed: int = 0
    shed: int = 0              # deadline expired while queued
    rejected: int = 0          # bounded queue full at submit
    failed: int = 0            # survivors could not hold the job
    preempted: int = 0         # best-effort leases evicted for SLO traffic
    requeued: int = 0          # preempted/failed-over requests re-admitted
    replaced: int = 0          # leases migrated after node failure
    replace_skipped: int = 0   # failure diff missed the lease (fast path)
    resized: int = 0           # elastic replica grow/shrink operations
    drain_ticks: int = 0
    failure_events: int = 0
    heartbeats: int = 0
    place_wall_s: float = 0.0  # wall-clock spent inside engine placement
    admission: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    completion: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    queue_depths: list = dataclasses.field(default_factory=list)

    def sample_queue_depth(self, depth: int) -> None:
        self.queue_depths.append(int(depth))

    @property
    def peak_queue_depth(self) -> int:
        return max(self.queue_depths) if self.queue_depths else 0

    @property
    def mean_queue_depth(self) -> float:
        return (float(np.mean(self.queue_depths))
                if self.queue_depths else 0.0)

    def placements_per_sec(self) -> float:
        """Sustained engine throughput: placements per wall-clock second
        actually spent placing (re-placements and resizes included)."""
        n = self.placed + self.replaced + self.resized
        if self.place_wall_s <= 0:
            return 0.0
        return n / self.place_wall_s

    def to_row(self) -> dict:
        """Flatten into the BENCH-file row shape."""
        return {
            "submitted": self.submitted,
            "placed": self.placed,
            "completed": self.completed,
            "shed": self.shed,
            "rejected": self.rejected,
            "failed": self.failed,
            "preempted": self.preempted,
            "requeued": self.requeued,
            "replaced": self.replaced,
            "replace_skipped": self.replace_skipped,
            "resized": self.resized,
            "drain_ticks": self.drain_ticks,
            "failure_events": self.failure_events,
            "heartbeats": self.heartbeats,
            "place_wall_s": self.place_wall_s,
            "placements_per_sec": self.placements_per_sec(),
            "admission_p50_s": self.admission.p50,
            "admission_p99_s": self.admission.p99,
            "admission_mean_s": self.admission.mean,
            "completion_p50_s": self.completion.p50,
            "completion_p99_s": self.completion.p99,
            "peak_queue_depth": self.peak_queue_depth,
            "mean_queue_depth": self.mean_queue_depth,
        }


__all__ = ["LatencyHistogram", "ServiceMetrics"]
