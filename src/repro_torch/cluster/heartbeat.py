"""Heartbeat collection and outage-probability estimation.

The paper's *Fault Aware Slurmctld* plugin polls every node each interval
``t`` (``Hb(t, i)``); a missing reply marks an outage sample.  Node outage
probability is inferred by post-processing each node's heartbeat history
``HB(i)`` — the paper explicitly calls out moving / weighted-moving averages
as candidate policies.  Both are implemented here, plus the latency-based
straggler score used by the beyond-paper soft penalty.

**Units.**  The monitor's ``clock`` advances by ``dt`` simulated seconds
per ``poll`` (default 1.0 — one abstract round); sample timestamps and
reply latencies are in the same seconds.  Estimates are probabilities in
``[0, 1]`` per *round*: a node with ``p = 0.3`` misses ~30% of polls.

**Truth vs estimate.**  What ``poll`` records is *observed* replies; the
ground truth lives in the fault-injection layer
(:mod:`repro_torch.cluster.failures`) or
``NodeRegistry.true_outage_p``.  ``outage_probabilities()`` is therefore
the scheduler's *belief* — exactly the ``known_p_f`` side of the
contract documented on :func:`repro_torch.sim.batchsim.run_batch`:
``simulate_rounds`` with enough rounds converges that belief to the
truth (the paper's setting), few rounds model a cold or lagging
estimator.

**Determinism.**  The monitor itself never draws randomness;
``simulate_rounds`` draws reply misses from the explicit ``rng``
argument, so a heartbeat history is reproducible from its seed.

**Deprecation note.**  The :class:`OutageEstimator` hierarchy here
(:class:`MovingAverage` / :class:`EWMA`) predates the belief subsystem
in :mod:`repro_torch.beliefs` and survives as the monitor's default
post-processing only.  New estimation code should implement the
:class:`repro_torch.beliefs.BeliefModel` protocol — which is horizon-aware
and learns from lifetime statistics rather than per-round miss
fractions — and these legacy estimators are available behind it via
:class:`repro_torch.beliefs.HeartbeatBeliefAdapter` so the monitor and the
:class:`repro_torch.beliefs.BeliefTracker` share one interface.  No removal
is scheduled (drain/degrade thresholds are calibrated against per-round
miss fractions), but the hierarchy is frozen: grow ``repro_torch.beliefs``
instead.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class HeartbeatSample:
    t: float
    ok: bool
    latency: float = 0.0   # reply latency (straggler signal), seconds


class OutageEstimator:
    """Base: estimate p_f from a heartbeat history."""

    def estimate(self, history: "deque[HeartbeatSample]") -> float:
        raise NotImplementedError


class MovingAverage(OutageEstimator):
    """p_f = fraction of missed heartbeats over the last ``window`` samples."""

    def __init__(self, window: int = 100):
        self.window = window

    def estimate(self, history) -> float:
        if not history:
            return 0.0
        recent = list(history)[-self.window:]
        return sum(0.0 if s.ok else 1.0 for s in recent) / len(recent)


class EWMA(OutageEstimator):
    """Exponentially weighted moving average of the miss indicator."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha

    def estimate(self, history) -> float:
        p = 0.0
        for s in history:
            p = (1 - self.alpha) * p + self.alpha * (0.0 if s.ok else 1.0)
        return p


class HeartbeatMonitor:
    """Fault Aware Slurmctld: maintains HB(i) per node, infers p_f vector."""

    def __init__(self, n_nodes: int, estimator: OutageEstimator | None = None,
                 max_history: int = 1000):
        self.n_nodes = n_nodes
        self.estimator = estimator or MovingAverage()
        self.history: list[deque] = [deque(maxlen=max_history)
                                     for _ in range(n_nodes)]
        self.clock = 0.0

    def poll(self, replies: np.ndarray, latencies: np.ndarray | None = None,
             dt: float = 1.0) -> None:
        """One heartbeat round: ``replies[i]`` True if node i answered.

        ``dt`` is the poll interval in simulated seconds (the paper's
        ``t``); ``latencies`` are per-node reply latencies in seconds
        (straggler signal), ignored for missing replies."""
        self.clock += dt
        for i in range(self.n_nodes):
            lat = float(latencies[i]) if latencies is not None else 0.0
            self.history[i].append(
                HeartbeatSample(self.clock, bool(replies[i]), lat))

    def outage_probabilities(self) -> np.ndarray:
        return np.array([self.estimator.estimate(h) for h in self.history])

    def straggler_scores(self, baseline_latency: float = 1e-3) -> np.ndarray:
        """Relative slowdown per node from heartbeat reply latency."""
        out = np.zeros(self.n_nodes)
        for i, h in enumerate(self.history):
            lats = [s.latency for s in h if s.ok and s.latency > 0]
            if lats:
                med = float(np.median(lats))
                out[i] = max(0.0, med / baseline_latency - 1.0)
        return out

    def simulate_rounds(
        self, rng: np.random.Generator, true_p: np.ndarray,
        n_rounds: int, slowdown: np.ndarray | None = None,
        baseline_latency: float = 1e-3,
    ) -> None:
        """Drive the monitor with synthetic heartbeats: node i misses each
        round with its true outage probability (the NodeState plugin simply
        does not answer while a node is down).

        ``true_p`` is the *ground-truth* per-round miss probability; all
        draws come from ``rng``, so the resulting estimate trajectory is
        reproducible from the seed.  ~400 rounds converge a default
        ``MovingAverage`` to within a few percent of ``true_p`` (see the
        reference package's ``tests/test_cluster.py``); the event
        simulator instead issues live HEARTBEAT events for the same effect
        over simulated time."""
        for _ in range(n_rounds):
            replies = rng.random(self.n_nodes) >= true_p
            lat = np.full(self.n_nodes, baseline_latency)
            if slowdown is not None:
                lat = baseline_latency * (1.0 + slowdown)
            self.poll(replies, lat)
