"""Outage-belief estimators: hazard-rate models behind one protocol.

The scheduler's fault-aware placement consumes one artifact — a per-node
outage-probability vector ``p_f`` — and the paper's headline result
(18.9-31% completion-time reduction) is only as good as that belief.
This module is the estimation side of the loop: a common
:class:`BeliefModel` protocol mapping observed per-node lifetime
statistics (:class:`LifetimeStats`, maintained incrementally by
:class:`~repro_torch.beliefs.tracker.BeliefTracker`) to calibrated horizon
probabilities ``P(>= 1 failure within a job of the given duration)``.

Estimator catalog (see ``docs/BELIEFS.md`` for the math):

* :class:`ExponentialBayes` — conjugate Bayesian exponential-lifetime
  model: Gamma(a0, b0) prior over the per-node failure rate, posterior
  Gamma(a0 + k, b0 + T) after ``k`` observed failures over exposure
  ``T``, and the *closed-form* posterior-predictive horizon probability
  ``p_f(d) = 1 - (b / (b + d))^a`` (Lomax survival).
* :class:`WeibullMoM` — Weibull lifetime fitter by method of moments
  (shape from the coefficient of variation via a scipy-free bisection,
  scale from the mean), with shape-aware horizon probabilities
  ``1 - exp(-(d / scale)^shape)``; nodes with too few completed
  lifetimes fall back to a conjugate exponential model.
* :class:`RackPooledBayes` — hierarchical empirical-Bayes shrinkage:
  each rack's pooled Gamma posterior becomes the prior for its member
  nodes (pseudo-count ``strength``), so sparse per-node histories
  borrow statistical strength from their rack — the estimator matched
  to :class:`~repro_torch.cluster.failures.CorrelatedOutages` /
  :class:`~repro_torch.cluster.failures.CascadingOutages` group structure.

Reference beliefs for sweeps: :class:`OracleBeliefs` (ground truth),
:class:`StaticPrior` (uniform, uninformed) and
:class:`AdversarialBeliefs` (truth mass on the wrong nodes).
:class:`HeartbeatBeliefAdapter` wraps the legacy
:class:`~repro_torch.cluster.heartbeat.OutageEstimator` hierarchy
(MovingAverage / EWMA) behind the same protocol, so the heartbeat
monitor and the belief tracker share one interface.

**Pattern dominance.**  Every in-tree Eq. 1 consumer reads the belief
through the ``p_f > 0`` indicator (the paper's ``1[p_f > 0]`` route
penalty), so what placement quality actually depends on is the *set* of
nodes with nonzero belief.  Learned estimators therefore must not leak
tiny positive posteriors onto healthy nodes — the tracker applies an
emission floor (``p_floor``) that clamps sub-threshold probabilities to
exactly zero.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LifetimeStats:
    """Sufficient statistics of one node population's observed lifetimes.

    Maintained O(1)-per-event by :class:`~repro_torch.beliefs.tracker.
    BeliefTracker`; every array is shaped ``(n_nodes,)``.  ``exposure``
    includes the *censored* current up-interval (time since the last
    repair with no failure yet), while ``sum_life`` / ``sum_life_sq``
    aggregate *completed* lifetimes only — the moments a distribution
    fitter may use.
    """

    n_failures: np.ndarray      # observed failures per node
    exposure: np.ndarray        # total observed up-time, seconds (censored
                                # current interval included)
    sum_life: np.ndarray        # sum of completed lifetimes, seconds
    sum_life_sq: np.ndarray     # sum of squared completed lifetimes
    down: np.ndarray            # bool: currently in an outage

    @property
    def n_nodes(self) -> int:
        return len(self.n_failures)

    @classmethod
    def empty(cls, n_nodes: int) -> "LifetimeStats":
        z = np.zeros(n_nodes, dtype=np.float64)
        return cls(z, z.copy(), z.copy(), z.copy(),
                   np.zeros(n_nodes, dtype=bool))


class BeliefModel:
    """Protocol: observed lifetime statistics -> per-node ``p_f`` vector.

    ``p_f(stats, duration)`` returns the probability, per node, of at
    least one failure within a job window of ``duration`` simulated
    seconds.  Implementations must be pure functions of ``(stats,
    duration)`` — all mutable accounting lives in the tracker — and
    vectorized over nodes.
    """

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class ExponentialBayes(BeliefModel):
    """Conjugate Gamma-exponential hazard model.

    Prior over each node's failure rate: Gamma(``prior_events``,
    ``prior_exposure``) (shape/rate parametrization — prior mean rate
    ``prior_events / prior_exposure`` per second, weight equivalent to
    ``prior_exposure`` seconds of failure-free observation).  With ``k``
    observed failures over exposure ``T`` the posterior is
    Gamma(a, b) = Gamma(``prior_events + k``, ``prior_exposure + T``)
    and the posterior-predictive probability of surviving a window ``d``
    is ``E[exp(-lambda d)] = (b / (b + d))^a``, hence::

        p_f(d) = 1 - (b / (b + d)) ** a

    — closed form, no sampling, exact under exponential lifetimes.
    """

    prior_events: float = 0.5
    prior_exposure: float = 100.0

    def __post_init__(self):
        if self.prior_events <= 0 or self.prior_exposure <= 0:
            raise ValueError("Gamma prior needs positive shape and rate")

    def posterior(self, stats: LifetimeStats) -> tuple[np.ndarray, np.ndarray]:
        """Per-node posterior Gamma (shape ``a``, rate ``b``) arrays."""
        a = self.prior_events + stats.n_failures
        b = self.prior_exposure + stats.exposure
        return a, b

    def posterior_mean_rate(self, stats: LifetimeStats) -> np.ndarray:
        a, b = self.posterior(stats)
        return a / b

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        a, b = self.posterior(stats)
        return 1.0 - (b / (b + duration)) ** a


def _weibull_shape_from_cv2(cv2: np.ndarray, lo: float = 0.08,
                            hi: float = 25.0, iters: int = 60) -> np.ndarray:
    """Invert the Weibull squared coefficient of variation to the shape.

    ``CV^2(k) = Gamma(1 + 2/k) / Gamma(1 + 1/k)^2 - 1`` is strictly
    decreasing in the shape ``k`` (heavy-tailed shapes < 1 have CV > 1),
    so a plain bisection recovers ``k`` from sample moments without
    scipy.  Inputs outside the bracket clamp to the bracket ends.
    """
    lgamma = np.frompyfunc(math.lgamma, 1, 1)

    def cv2_of(k: np.ndarray) -> np.ndarray:
        k = np.asarray(k, dtype=np.float64)
        g2 = np.asarray(lgamma(1.0 + 2.0 / k), dtype=np.float64)
        g1 = np.asarray(lgamma(1.0 + 1.0 / k), dtype=np.float64)
        return np.exp(g2 - 2.0 * g1) - 1.0

    cv2 = np.asarray(cv2, dtype=np.float64)
    cv2 = np.clip(cv2, cv2_of(np.array(hi)), cv2_of(np.array(lo)))
    a = np.full(cv2.shape, lo)
    b = np.full(cv2.shape, hi)
    for _ in range(iters):
        mid = 0.5 * (a + b)
        too_heavy = cv2_of(mid) > cv2       # CV too big -> shape above mid
        a = np.where(too_heavy, mid, a)
        b = np.where(too_heavy, b, mid)
    return 0.5 * (a + b)


@dataclasses.dataclass
class WeibullMoM(BeliefModel):
    """Weibull lifetime fitter by method of moments.

    Per node, the completed-lifetime sample mean and variance give the
    coefficient of variation; :func:`_weibull_shape_from_cv2` inverts it
    to the shape and the mean fixes the scale
    (``scale = mean / Gamma(1 + 1/shape)``).  The horizon probability is
    the Weibull first-failure CDF ``1 - exp(-(d / scale)^shape)`` — for
    LANL-style infant-mortality lifetimes (shape < 1) this is *larger*
    at short horizons than the exponential model with the same mean,
    which is exactly the signal a fault-aware placement wants.

    Nodes with fewer than ``min_samples`` completed lifetimes (or a
    degenerate variance) fall back to ``fallback`` — censored exposure
    carries no moment information, so sparse histories are better served
    by the conjugate model.
    """

    min_samples: int = 3
    fallback: BeliefModel = dataclasses.field(default_factory=ExponentialBayes)

    def __post_init__(self):
        if self.min_samples < 2:
            raise ValueError("Weibull MoM needs min_samples >= 2 "
                             "(variance is undefined below two lifetimes)")

    def fit(self, stats: LifetimeStats
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-node ``(shape, scale, fitted)``; unfitted entries hold 1.0
        shape and +inf scale with ``fitted`` False."""
        k = stats.n_failures
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(k > 0, stats.sum_life / np.maximum(k, 1), 0.0)
            var = np.where(k > 0,
                           stats.sum_life_sq / np.maximum(k, 1) - mean ** 2,
                           0.0)
        fitted = (k >= self.min_samples) & (mean > 0) & (var > 1e-12 * mean**2)
        cv2 = np.where(fitted, var / np.maximum(mean ** 2, 1e-300), 1.0)
        shape = np.where(fitted, _weibull_shape_from_cv2(cv2), 1.0)
        lgamma = np.frompyfunc(math.lgamma, 1, 1)
        gam = np.exp(lgamma(1.0 + 1.0 / shape).astype(np.float64))
        scale = np.where(fitted, mean / gam, np.inf)
        return shape, scale, fitted

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        shape, scale, fitted = self.fit(stats)
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            p = 1.0 - np.exp(-(duration / scale) ** shape)
        return np.where(fitted, p, self.fallback.p_f(stats, duration))


@dataclasses.dataclass
class RackPooledBayes(BeliefModel):
    """Hierarchical rack-pooled conjugate model.

    Two-level empirical Bayes: each rack's pooled history (summed
    failures and exposure of its members) yields a rack-level Gamma
    posterior whose mean rate becomes the *prior* mean for every member
    node, with prior weight ``strength`` pseudo-failures.  A node with a
    rich history converges to its own rate; a node with a sparse history
    is shrunk toward its rack's — the right bias when outages are
    rack-correlated (shared PDU / top-of-rack switch), and provably
    lower-MSE than per-node estimation on sparse histories (see the
    reference package's ``tests/test_beliefs.py``).

    ``groups`` is the rack membership (e.g. :func:`~repro_torch.cluster.
    failures.contiguous_racks` or ``ClusterState.groups``); nodes not
    covered by any group get the plain un-pooled posterior.
    """

    groups: Sequence[Sequence[int]]
    strength: float = 2.0
    prior_events: float = 0.5
    prior_exposure: float = 100.0

    def __post_init__(self):
        if self.strength <= 0:
            raise ValueError("strength must be > 0")
        self._gidx_cache: Optional[np.ndarray] = None

    def _group_index(self, n: int) -> np.ndarray:
        if self._gidx_cache is None or len(self._gidx_cache) != n:
            gidx = np.full(n, -1, dtype=np.int64)
            for gi, grp in enumerate(self.groups):
                gidx[np.asarray(grp, dtype=np.int64)] = gi
            self._gidx_cache = gidx
        return self._gidx_cache

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        n = stats.n_nodes
        gidx = self._group_index(n)
        n_groups = len(self.groups)
        k_g = np.zeros(n_groups)
        t_g = np.zeros(n_groups)
        grouped = gidx >= 0
        np.add.at(k_g, gidx[grouped], stats.n_failures[grouped])
        np.add.at(t_g, gidx[grouped], stats.exposure[grouped])
        # rack-level posterior mean rate under the top-level prior
        lam_g = (self.prior_events + k_g) / (self.prior_exposure + t_g)
        lam0 = self.prior_events / self.prior_exposure
        lam_prior = np.where(grouped, lam_g[np.maximum(gidx, 0)], lam0)
        # node prior Gamma(strength, strength / lam_prior): mean lam_prior,
        # weight `strength` pseudo-failures -> conjugate node posterior
        a = self.strength + stats.n_failures
        b = self.strength / lam_prior + stats.exposure
        return 1.0 - (b / (b + duration)) ** a


# ------------------------------------------------- reference / sweep models
@dataclasses.dataclass
class OracleBeliefs(BeliefModel):
    """Ground truth handed straight to the scheduler — the zero-error
    anchor of the belief sweep (the paper's 'scheduler knows p_f'
    setting)."""

    p_truth: np.ndarray

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        return np.asarray(self.p_truth, dtype=np.float64).copy()


@dataclasses.dataclass
class StaticPrior(BeliefModel):
    """An uninformed static prior: the same ``p0`` on every node.

    Because Eq. 1 consumers read the ``p_f > 0`` pattern, a uniform
    positive prior penalizes every route equally — placement degrades to
    fault-*blind* (still topology-aware) behavior.  This is the baseline
    a learned estimator must beat.
    """

    p0: float = 0.1

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        return np.full(stats.n_nodes, float(self.p0))


@dataclasses.dataclass
class AdversarialBeliefs(BeliefModel):
    """Truth mass on the wrong nodes: the ground-truth vector reversed in
    id order, so the belief steers placements *toward* the flaky zone
    and away from healthy capacity — the worst-case end of the
    belief-error axis (assumes the flaky set is not id-symmetric, which
    holds for every in-tree preset)."""

    p_truth: np.ndarray

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        return np.asarray(self.p_truth, dtype=np.float64)[::-1].copy()


class HeartbeatBeliefAdapter(BeliefModel):
    """Adapter: a legacy :class:`~repro_torch.cluster.heartbeat.OutageEstimator`
    (MovingAverage / EWMA) + its monitor's histories, behind the
    :class:`BeliefModel` protocol.

    The legacy estimators post-process heartbeat *miss fractions* and
    return per-round probabilities with no horizon model, so ``p_f``
    ignores ``duration`` (documented horizon-blindness) and reads the
    monitor's histories instead of the tracker's lifetime statistics.
    This is the bridge that lets the monitor and the tracker share one
    interface while the legacy hierarchy is deprecated in place — see
    the note in :mod:`repro_torch.cluster.heartbeat`.
    """

    def __init__(self, estimator, monitor):
        self.estimator = estimator
        self.monitor = monitor

    def p_f(self, stats: LifetimeStats, duration: float) -> np.ndarray:
        return np.array([self.estimator.estimate(h)
                         for h in self.monitor.history])


__all__ = [
    "LifetimeStats", "BeliefModel", "ExponentialBayes", "WeibullMoM",
    "RackPooledBayes", "OracleBeliefs", "StaticPrior", "AdversarialBeliefs",
    "HeartbeatBeliefAdapter",
]
