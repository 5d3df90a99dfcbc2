"""Online outage-belief subsystem.

Learns per-node / per-rack hazard rates from observed failure events and
feeds calibrated ``p_f`` vectors into fault-aware placement — see
``docs/BELIEFS.md`` for the estimator catalog, the truth-vs-estimate
contract, and the reference package's belief-error sweep
(``benchmarks/belief_sweep.py``).
"""
from .calibration import (belief_mae, belief_mse, brier_score,
                          expected_calibration_error, log_loss,
                          pattern_confusion, reliability_diagram,
                          window_outcomes)
from .estimators import (AdversarialBeliefs, BeliefModel, ExponentialBayes,
                         HeartbeatBeliefAdapter, LifetimeStats,
                         OracleBeliefs, RackPooledBayes, StaticPrior,
                         WeibullMoM)
from .tracker import BeliefTracker

__all__ = [
    "BeliefModel", "LifetimeStats", "ExponentialBayes", "WeibullMoM",
    "RackPooledBayes", "OracleBeliefs", "StaticPrior",
    "AdversarialBeliefs", "HeartbeatBeliefAdapter", "BeliefTracker",
    "brier_score", "log_loss", "belief_mse", "belief_mae",
    "reliability_diagram", "expected_calibration_error",
    "pattern_confusion", "window_outcomes",
]
