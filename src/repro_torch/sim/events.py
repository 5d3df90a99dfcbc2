"""Discrete-event core: typed events and a deterministic event heap.

The cluster simulator (:mod:`repro_torch.sim.clustersim`) advances simulated
time by popping events off an :class:`EventQueue`.  Two properties make
runs reproducible bit-for-bit:

* **Total order.**  Events sort by ``(time, type priority, sequence)``.
  The type priority resolves ties at equal timestamps with fixed
  semantics (see :class:`EventType`); the monotonically increasing
  sequence number resolves the remaining ties in insertion order, so two
  identical runs pop identical event streams.
* **Lazy invalidation.**  Events scheduled for a job attempt carry the
  attempt id; a consumer drops events whose attempt has since been
  superseded (e.g. the COMPLETE of an attempt that was aborted by a
  FAILURE) instead of searching the heap for them.

All times are simulated **seconds** on one global clock starting at 0.0.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Any, Iterator, Optional


class EventType(enum.IntEnum):
    """Event kinds, ordered by tie-break priority at equal timestamps.

    Lower value pops first.  The order encodes the simulator's
    simultaneity semantics:

    * ``COMPLETE`` before ``FAILURE``: a job that finishes at *t* is done
      before a node failing at the same instant can kill it (the benign
      reading; the paper's SimGrid platform makes the same call because a
      finished transmission cannot be varied to zero capacity).
    * ``FAILURE`` before ``RECOVER``: a zero-downtime blip still aborts
      the jobs it touches.
    * ``RECOVER`` and ``HEARTBEAT`` before ``SUBMIT``/``START``: a
      submission at a repair instant or heartbeat tick sees the freshest
      capacity and health estimate.
    * ``START`` last: scheduling decisions run after every state change
      at the same timestamp.
    """

    COMPLETE = 0
    FAILURE = 1
    RECOVER = 2
    HEARTBEAT = 3
    CHECKPOINT = 4
    SUBMIT = 5
    START = 6


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence: a timestamp, a kind, and a payload.

    ``seq`` is assigned by the queue at push time and makes the sort key
    ``(time, type, seq)`` unique.  ``data`` is an arbitrary payload dict
    owned by the producer (job ids, node arrays, attempt counters ...).
    """

    time: float
    type: EventType
    seq: int
    data: dict = dataclasses.field(default_factory=dict)

    def __getitem__(self, key: str) -> Any:
        return self.data[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.data.get(key, default)


class EventQueue:
    """Min-heap of :class:`Event` with the deterministic total order.

    ``push`` stamps the sequence number; ``pop`` returns the earliest
    event under ``(time, type priority, seq)``.  Pushing an event in the
    past (``time < last popped time``) raises ``ValueError`` — the loop
    never travels backwards.
    """

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, int, Event]] = []
        self._seq = itertools.count()
        self._now = 0.0
        self.pushed = 0
        self.popped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    @property
    def now(self) -> float:
        """Timestamp of the last popped event (0.0 before any pop)."""
        return self._now

    def push(self, time: float, type: EventType, **data: Any) -> Event:
        if time < self._now:
            raise ValueError(
                f"event at t={time} is in the past (clock at {self._now})")
        ev = Event(float(time), EventType(type), next(self._seq), data)
        heapq.heappush(self._heap, (ev.time, int(ev.type), ev.seq, ev))
        self.pushed += 1
        return ev

    def pop(self) -> Event:
        if not self._heap:
            raise IndexError("pop from empty EventQueue")
        _, _, _, ev = heapq.heappop(self._heap)
        self._now = ev.time
        self.popped += 1
        return ev

    def peek(self) -> Optional[Event]:
        return self._heap[0][3] if self._heap else None

    def drain(self) -> Iterator[Event]:
        """Pop until empty (mainly for tests)."""
        while self._heap:
            yield self.pop()
