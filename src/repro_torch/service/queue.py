"""SLO-aware admission queue of the online placement service.

One lane per :class:`~repro_torch.service.requests.SLOClass`, drained in lane
priority order; within a lane, requests are ordered earliest-deadline
first (EDF — ties broken by arrival sequence, so runs are deterministic).
Three protections keep the queue honest under overload:

* **Load shedding on admit** — a bounded queue (``max_depth``) rejects
  new arrivals outright instead of growing without bound; a request
  whose deadline has already passed is never admitted.
* **Deadline shedding on drain** — every drain tick first drops queued
  requests whose admission deadline has expired; they leave with a
  ``shed`` reply rather than consuming placement capacity.
* **Capacity-bounded batching** — :meth:`drain` returns at most what the
  currently-free node count can hold (count-based, like the batch
  scheduler's admission step), backfilling smaller requests past a
  blocked wide head within and across lanes.  The service places the
  whole returned batch with one
  :meth:`~repro_torch.core.engine.PlacementEngine.place_many` call.
"""
from __future__ import annotations

import bisect
import itertools
from typing import Optional

from repro_torch.service.requests import ServiceRequest, SLOClass


class AdmissionQueue:
    """Per-SLO priority lanes with EDF order, shedding and bounded depth."""

    def __init__(self, max_depth: Optional[int] = None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        # lane -> sorted list of (deadline, seq, request)
        self._lanes: dict[SLOClass, list] = {c: [] for c in SLOClass}
        self._seq = itertools.count()
        self.peak_depth = 0

    # -------------------------------------------------------------- state
    def __len__(self) -> int:
        return sum(len(v) for v in self._lanes.values())

    def __bool__(self) -> bool:
        return len(self) > 0

    @property
    def depth(self) -> int:
        return len(self)

    def depths(self) -> dict[str, int]:
        """Current queue depth per lane (keyed by SLO class name)."""
        return {c.name: len(v) for c, v in self._lanes.items()}

    def head(self, lane: SLOClass) -> Optional[ServiceRequest]:
        """The next request a drain would consider for ``lane`` (EDF)."""
        entries = self._lanes[lane]
        return entries[0][2] if entries else None

    # ------------------------------------------------------------- admit
    def push(self, req: ServiceRequest, now: float) -> bool:
        """Admit ``req``; False means *rejected* (queue full) or the
        deadline has already passed (the caller sheds it)."""
        if req.deadline <= now:
            return False
        if self.max_depth is not None and len(self) >= self.max_depth:
            return False
        entries = self._lanes[req.slo]
        bisect.insort(entries, (req.deadline, next(self._seq), req))
        self.peak_depth = max(self.peak_depth, len(self))
        return True

    def shed_expired(self, now: float) -> list[ServiceRequest]:
        """Remove and return every queued request whose deadline passed."""
        shed: list[ServiceRequest] = []
        for entries in self._lanes.values():
            keep = []
            for item in entries:
                (shed if item[0] <= now else keep).append(item)
            entries[:] = keep
        return [item[2] for item in sorted(shed)]

    # ------------------------------------------------------------- drain
    def drain(self, now: float, capacity: int,
              max_batch: Optional[int] = None) -> list[ServiceRequest]:
        """Pop the batch one drain tick should place.

        Lanes drain in priority order, EDF within a lane; a request that
        does not fit the remaining node ``capacity`` is left queued while
        later (smaller) requests may still backfill.  Expired requests
        must be collected with :meth:`shed_expired` first — drain
        assumes live deadlines."""
        batch: list[ServiceRequest] = []
        free = int(capacity)
        for lane in SLOClass:
            entries = self._lanes[lane]
            keep = []
            for item in entries:
                req = item[2]
                if free >= req.n_ranks and (
                        max_batch is None or len(batch) < max_batch):
                    batch.append(req)
                    free -= req.n_ranks
                else:
                    keep.append(item)
            entries[:] = keep
        return batch

    def remove(self, req_id: int) -> Optional[ServiceRequest]:
        """Pull one request out of its lane (cancellation)."""
        for entries in self._lanes.values():
            for i, item in enumerate(entries):
                if item[2].req_id == req_id:
                    entries.pop(i)
                    return item[2]
        return None


__all__ = ["AdmissionQueue"]
