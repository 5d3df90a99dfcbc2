"""Fault injection models: per-attempt scenarios and time-based processes.

Two layers, consumed by different simulators:

**Per-attempt models** (:class:`FailureModel`) — the paper's Section 5.2
semantics: a fixed candidate set ``N_f`` of nodes each enters the failed
state independently with probability ``p_f`` *per simulated scenario*
(= per job attempt).  A failed node can neither compute nor forward
traffic; restart is instantaneous; no checkpointing.  The draw is local
to one attempt — it does not change cluster state for other jobs.  Used
by :func:`repro_torch.sim.batchsim.run_batch` and by the event simulator's
paper-equivalence mode.

**Time-based processes** (:class:`FailureProcess`) — beyond-paper node
*lifecycles* over continuous simulated time: a node is UP until its
lifetime expires, DOWN until repaired, and so on.  ``generate`` expands a
process into a sorted trace of :class:`NodeEvent` (fail/repair, possibly
correlated across a rack) that the event simulator replays as FAILURE /
RECOVER heap events; a mid-run failure aborts every job whose placement
holds the node.  Lifetime distributions follow the LANL-trace analysis
the paper cites [34]: exponential and Weibull (shape < 1 ==
infant-mortality-heavy).

All times are simulated seconds; every stochastic draw takes an explicit
``numpy.random.Generator`` so traces are reproducible from a seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


class FailureModel:
    def sample_failed(self, rng: np.random.Generator, duration: float
                      ) -> np.ndarray:
        """Node ids in the failed state for one job instance."""
        raise NotImplementedError


@dataclasses.dataclass
class NoFailures(FailureModel):
    def sample_failed(self, rng, duration) -> np.ndarray:
        return np.array([], dtype=np.int64)


@dataclasses.dataclass
class BernoulliPerJob(FailureModel):
    """The paper's model: each candidate fails w.p. ``p_f`` per instance."""

    candidates: np.ndarray
    p_f: float

    def sample_failed(self, rng, duration) -> np.ndarray:
        cand = np.asarray(self.candidates)
        mask = rng.random(len(cand)) < self.p_f
        return cand[mask]

    def outage_vector(self, n_nodes: int) -> np.ndarray:
        """Ground-truth p_f vector (what a converged heartbeat estimator
        reports to the placement policy)."""
        p = np.zeros(n_nodes)
        p[np.asarray(self.candidates)] = self.p_f
        return p


@dataclasses.dataclass
class WeibullArrival(FailureModel):
    """Failures arrive per node as a Weibull renewal process (shape < 1:
    infant-mortality-heavy, per LANL data); a node hit during the job's
    window is failed for that instance."""

    candidates: np.ndarray
    mtbf: float            # mean time between failures per candidate node
    shape: float = 0.7

    def sample_failed(self, rng, duration) -> np.ndarray:
        cand = np.asarray(self.candidates)
        # P(>=1 failure within the job window) for the renewal process;
        # exponential bound is exact for shape == 1 and a good approximation
        # in the duration << mtbf regime the simulator operates in
        p = 1.0 - np.exp(-(duration / self.mtbf) ** self.shape)
        mask = rng.random(len(cand)) < p
        return cand[mask]

    def outage_vector(self, n_nodes: int) -> np.ndarray:
        p = np.zeros(n_nodes)
        p[np.asarray(self.candidates)] = min(1.0, 1.0 / max(self.mtbf, 1e-9))
        return p


# --------------------------------------------------------------------------
# Time-based failure processes (event-simulator layer)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeEvent:
    """One state transition in a failure trace.

    ``kind`` is ``"fail"`` or ``"repair"``; ``nodes`` is the (possibly
    correlated) group that transitions together at ``time`` seconds.
    """

    time: float
    kind: str
    nodes: tuple[int, ...]


class FailureProcess:
    """Base: a generator of node fail/repair traces over [0, horizon]."""

    def generate(self, rng: np.random.Generator, horizon: float
                 ) -> list[NodeEvent]:
        """Sorted fail/repair events up to ``horizon`` (exclusive).

        The trace is *open-loop*: it does not know what the simulator does
        with the nodes.  A ``fail`` for a node already down (e.g. a rack
        outage overlapping a node outage) is legal; the simulator treats
        node state as a counter, not a boolean.
        """
        raise NotImplementedError

    def expected_p_f(self, n_nodes: int) -> np.ndarray:
        """Steady-state per-node unavailability (fraction of time down) —
        what a long-converged heartbeat estimator would report.  Used by
        scenarios that hand the scheduler the ground truth instead of
        simulating heartbeat convergence."""
        raise NotImplementedError


def _renewal_trace(rng: np.random.Generator, node: int, horizon: float,
                   draw_life, draw_repair) -> list[NodeEvent]:
    """Alternating up/down renewal sequence for one node."""
    out: list[NodeEvent] = []
    t = float(draw_life(rng))
    while t < horizon:
        out.append(NodeEvent(t, "fail", (node,)))
        if draw_repair is None:           # permanent failure
            break
        t += float(draw_repair(rng))
        if t >= horizon:
            break
        out.append(NodeEvent(t, "repair", (node,)))
        t += float(draw_life(rng))
    return out


class _RenewalLifetimes(FailureProcess):
    """Shared machinery for per-node alternating-renewal lifecycles.

    Subclasses are dataclasses declaring ``candidates``, ``mtbf`` and
    ``mttr`` (``None`` = permanent failures) and implement ``_draw_life``
    — the up-time distribution.  Repairs are exponential with mean
    ``mttr``; steady-state unavailability is ``mttr / (mtbf + mttr)``.
    """

    def _draw_life(self, rng: np.random.Generator) -> float:
        raise NotImplementedError

    def generate(self, rng, horizon) -> list[NodeEvent]:
        rep = None if self.mttr is None else (
            lambda r: r.exponential(self.mttr))
        out: list[NodeEvent] = []
        for node in np.asarray(self.candidates, dtype=np.int64):
            out += _renewal_trace(rng, int(node), horizon,
                                  self._draw_life, rep)
        return sorted(out, key=lambda e: e.time)

    def expected_p_f(self, n_nodes) -> np.ndarray:
        p = np.zeros(n_nodes)
        frac = (1.0 if self.mttr is None
                else self.mttr / (self.mtbf + self.mttr))
        p[np.asarray(self.candidates, dtype=np.int64)] = frac
        return p


@dataclasses.dataclass
class ExponentialLifetimes(_RenewalLifetimes):
    """Memoryless per-node lifetimes: up ~ Exp(``mtbf``), down ~
    Exp(``mttr``); ``mttr=None`` makes failures permanent."""

    candidates: Sequence[int]
    mtbf: float                         # mean time between failures, seconds
    mttr: Optional[float] = None        # mean time to repair; None = no repair

    def _draw_life(self, rng) -> float:
        return rng.exponential(self.mtbf)


@dataclasses.dataclass
class WeibullLifetimes(_RenewalLifetimes):
    """Weibull per-node lifetimes with mean ``mtbf`` and shape ``shape``
    (< 1 == infant-mortality-heavy, the LANL-trace regime [34]); repairs
    are exponential with mean ``mttr``."""

    candidates: Sequence[int]
    mtbf: float
    shape: float = 0.7
    mttr: Optional[float] = None

    def __post_init__(self):
        if self.shape <= 0:
            raise ValueError(f"Weibull shape must be > 0, got {self.shape}")

    @property
    def scale(self) -> float:
        """Weibull scale lambda such that the mean equals ``mtbf``."""
        return self.mtbf / math.gamma(1.0 + 1.0 / self.shape)

    def _draw_life(self, rng) -> float:
        return self.scale * rng.weibull(self.shape)


@dataclasses.dataclass
class CorrelatedOutages(FailureProcess):
    """Rack/switch-level outages: whole node groups fail and repair
    together — the shared-PDU / top-of-rack-switch failure mode that
    per-node models cannot express.  Per group, an alternating renewal:
    up-time to the next outage ~ Exp(``mtbf``) measured from the previous
    repair, outage duration ~ Exp(``mttr``) (mean cycle ``mtbf + mttr``,
    steady-state unavailability ``mttr / (mtbf + mttr)``; outages never
    overlap within a group)."""

    groups: Sequence[Sequence[int]]
    mtbf: float
    mttr: float

    def generate(self, rng, horizon) -> list[NodeEvent]:
        out: list[NodeEvent] = []
        for grp in self.groups:
            nodes = tuple(int(x) for x in np.asarray(grp, dtype=np.int64))
            t = float(rng.exponential(self.mtbf))
            while t < horizon:
                out.append(NodeEvent(t, "fail", nodes))
                dt = float(rng.exponential(self.mttr))
                if t + dt < horizon:
                    out.append(NodeEvent(t + dt, "repair", nodes))
                t += dt + float(rng.exponential(self.mtbf))
        return sorted(out, key=lambda e: e.time)

    def expected_p_f(self, n_nodes) -> np.ndarray:
        p = np.zeros(n_nodes)
        frac = self.mttr / (self.mtbf + self.mttr)
        for grp in self.groups:
            p[np.asarray(grp, dtype=np.int64)] = frac
        return p


@dataclasses.dataclass
class CascadingOutages(FailureProcess):
    """Cascading rack failures: an outage spreads to adjacent racks.

    Seed outages follow the :class:`CorrelatedOutages` renewal per group
    (up-time ~ Exp(``mtbf``) from the previous repair, outage duration ~
    Exp(``mttr``)), but every outage — seed or induced — additionally
    *cascades*: each adjacent group (neighbours in ``groups`` list order,
    the shared-aisle/PDU adjacency of contiguous racks) fails with
    probability ``spread_p`` after an Exp(``spread_delay``) lag.  Induced
    outages repair after Exp(``mttr``) and can cascade onward; within one
    cascade tree each group fails at most once, so trees terminate.

    ``seed_groups`` restricts *spontaneous* outages to the given group
    indices (default: all groups seed) — the others only ever fail by
    contagion, which is the stress case for a fault-aware scheduler whose
    belief covers the flaky racks but not their healthy-looking
    neighbours.
    """

    groups: Sequence[Sequence[int]]
    mtbf: float
    mttr: float
    spread_p: float = 0.5
    spread_delay: float = 0.1
    seed_groups: Optional[Sequence[int]] = None

    def __post_init__(self):
        if not (0.0 <= self.spread_p <= 1.0):
            raise ValueError(f"spread_p must be in [0, 1], got {self.spread_p}")
        if self.spread_delay <= 0 or self.mttr <= 0 or self.mtbf <= 0:
            raise ValueError("mtbf, mttr and spread_delay must be > 0")

    def generate(self, rng, horizon) -> list[NodeEvent]:
        nodes = [tuple(int(x) for x in np.asarray(g, dtype=np.int64))
                 for g in self.groups]
        n_groups = len(nodes)
        seeds = (range(n_groups) if self.seed_groups is None
                 else [int(s) for s in self.seed_groups])
        out: list[NodeEvent] = []

        def emit(gi: int, t: float) -> float:
            """One outage of group ``gi`` at ``t``; returns repair time."""
            out.append(NodeEvent(t, "fail", nodes[gi]))
            dt = float(rng.exponential(self.mttr))
            if t + dt < horizon:
                out.append(NodeEvent(t + dt, "repair", nodes[gi]))
            return t + dt

        def cascade(gi: int, t: float, visited: set[int]) -> None:
            """Spread from an outage of ``gi`` at ``t`` to its neighbours
            (FIFO over the adjacency, deterministic draw order)."""
            frontier = [(gi, t)]
            while frontier:
                g0, t0 = frontier.pop(0)
                for nb in (g0 - 1, g0 + 1):
                    if nb < 0 or nb >= n_groups or nb in visited:
                        continue
                    if rng.random() >= self.spread_p:
                        continue
                    visited.add(nb)
                    t1 = t0 + float(rng.exponential(self.spread_delay))
                    if t1 >= horizon:
                        continue
                    emit(nb, t1)
                    frontier.append((nb, t1))

        # deterministic draw order: group-major over seeds, then each seed
        # outage's full cascade tree before the next outage of that seed
        for gi in seeds:
            t = float(rng.exponential(self.mtbf))
            while t < horizon:
                repaired = emit(gi, t)
                cascade(gi, t, {gi})
                t = repaired + float(rng.exponential(self.mtbf))
        return sorted(out, key=lambda e: e.time)

    def expected_p_f(self, n_nodes) -> np.ndarray:
        """Steady-state unavailability, one-hop cascade approximation:
        a group's outage rate is its own seed rate plus ``spread_p`` times
        each neighbouring seed's rate (deeper contagion terms dropped)."""
        n_groups = len(self.groups)
        seeds = (set(range(n_groups)) if self.seed_groups is None
                 else set(int(s) for s in self.seed_groups))
        lam_seed = 1.0 / self.mtbf
        p = np.zeros(n_nodes)
        for gi, grp in enumerate(self.groups):
            lam = lam_seed if gi in seeds else 0.0
            lam += self.spread_p * lam_seed * sum(
                1 for nb in (gi - 1, gi + 1)
                if 0 <= nb < n_groups and nb in seeds)
            frac = (lam * self.mttr) / (1.0 + lam * self.mttr)
            p[np.asarray(grp, dtype=np.int64)] = frac
        return p


@dataclasses.dataclass
class MaintenanceWindow(FailureProcess):
    """A scheduled maintenance drain: ``nodes`` leave service at ``start``
    and return at ``start + duration`` — one deterministic fail/repair
    pair (no RNG draw), so the window composes with stochastic processes
    without perturbing their draw order.  Jobs running on the nodes at
    ``start`` are aborted, exactly like a real drain deadline expiring.
    """

    nodes: Sequence[int]
    start: float
    duration: float

    def __post_init__(self):
        if self.start < 0 or self.duration <= 0:
            raise ValueError(
                f"need start >= 0 and duration > 0, got ({self.start}, "
                f"{self.duration})")

    def generate(self, rng, horizon) -> list[NodeEvent]:
        nodes = tuple(int(x) for x in np.asarray(self.nodes, dtype=np.int64))
        out: list[NodeEvent] = []
        if self.start < horizon:
            out.append(NodeEvent(self.start, "fail", nodes))
            end = self.start + self.duration
            if end < horizon:
                out.append(NodeEvent(end, "repair", nodes))
        return out

    def expected_p_f(self, n_nodes) -> np.ndarray:
        # a planned window is not a hazard the estimator should bake into
        # p_f; lifecycle (DRAINED/DOWN) carries it instead
        return np.zeros(n_nodes)


@dataclasses.dataclass
class CompositeProcess(FailureProcess):
    """Superposition of several processes (e.g. per-node Weibull churn +
    rack-level correlated outages) merged into one sorted trace."""

    processes: Sequence[FailureProcess]

    def generate(self, rng, horizon) -> list[NodeEvent]:
        out: list[NodeEvent] = []
        for p in self.processes:
            out += p.generate(rng, horizon)
        return sorted(out, key=lambda e: e.time)

    def expected_p_f(self, n_nodes) -> np.ndarray:
        # union bound on unavailability, clamped — processes overlap rarely
        # in the regimes the scenarios use
        p = np.zeros(n_nodes)
        for proc in self.processes:
            p = 1.0 - (1.0 - p) * (1.0 - proc.expected_p_f(n_nodes))
        return p


def contiguous_racks(n_nodes: int, rack_size: int) -> list[np.ndarray]:
    """Partition node ids into contiguous racks of ``rack_size``.

    Node ids follow resource-manager order in every in-tree topology
    (torus row-major, fat-tree (pod, edge, host)), so contiguous id
    blocks are physically co-located — a contiguous slice is the natural
    rack/chassis unit for correlated outages."""
    if rack_size <= 0:
        raise ValueError(f"rack_size must be positive, got {rack_size}")
    ids = np.arange(n_nodes)
    return [ids[i:i + rack_size] for i in range(0, n_nodes, rack_size)]
