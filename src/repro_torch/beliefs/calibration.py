"""Belief-calibration metrics vs. the failure-process ground truth.

The failure layer's :meth:`~repro_torch.cluster.failures.FailureProcess.
expected_p_f` is the truth a learned belief is scored against.  Two
families of metrics:

* **Probability quality** — :func:`brier_score`, :func:`log_loss` score
  a belief vector against realized binary outcomes (did the node fail
  within the window?); :func:`belief_mse` / :func:`belief_mae` score it
  directly against the truth vector; :func:`reliability_diagram` bins
  predictions for a calibration plot (predicted vs. empirical
  frequency per bin).
* **Pattern quality** — because Eq. 1 consumers read only the
  ``p_f > 0`` indicator, :func:`pattern_confusion` reports
  precision/recall of the *nonzero-belief set* against the
  nonzero-truth set; this is the metric that actually predicts
  placement quality (see the reference package's
  ``benchmarks/belief_sweep.py``).

:func:`window_outcomes` turns a generated event trace into the binary
per-window outcome matrix the scoring rules consume.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

_EPS = 1e-12


def _as_prob(p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    if np.any(p < -1e-9) or np.any(p > 1.0 + 1e-9):
        raise ValueError("probabilities must lie in [0, 1]")
    return np.clip(p, 0.0, 1.0)


def brier_score(p: np.ndarray, outcomes: np.ndarray) -> float:
    """Mean squared error of ``p`` against binary ``outcomes`` —
    0 is perfect, 0.25 is the uninformed p=0.5 forecast."""
    p = _as_prob(p)
    y = np.asarray(outcomes, dtype=np.float64)
    return float(np.mean((p - y) ** 2))


def log_loss(p: np.ndarray, outcomes: np.ndarray) -> float:
    """Mean negative log-likelihood of binary ``outcomes`` under ``p``
    (probabilities clipped away from {0, 1} for finiteness)."""
    p = np.clip(_as_prob(p), _EPS, 1.0 - _EPS)
    y = np.asarray(outcomes, dtype=np.float64)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


def belief_mse(p: np.ndarray, truth: np.ndarray) -> float:
    """Mean squared belief error against the truth probability vector."""
    return float(np.mean((_as_prob(p) - _as_prob(truth)) ** 2))


def belief_mae(p: np.ndarray, truth: np.ndarray) -> float:
    """Mean absolute belief error against the truth probability vector."""
    return float(np.mean(np.abs(_as_prob(p) - _as_prob(truth))))


def reliability_diagram(p: np.ndarray, outcomes: np.ndarray,
                        n_bins: int = 10) -> Dict[str, np.ndarray]:
    """Equal-width calibration bins over [0, 1].

    Returns ``bin_mid`` (bin centers), ``mean_pred`` (mean prediction
    per bin), ``frac_pos`` (empirical failure frequency per bin) and
    ``count`` (samples per bin); empty bins carry NaN means.  A
    calibrated forecaster has ``mean_pred ≈ frac_pos`` in every
    populated bin — the expected-calibration-error summary is
    ``sum(count * |mean_pred - frac_pos|) / sum(count)``.
    """
    p = _as_prob(p).ravel()
    y = np.asarray(outcomes, dtype=np.float64).ravel()
    if p.shape != y.shape:
        raise ValueError("p and outcomes must have matching shapes")
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(p, edges[1:-1]), 0, n_bins - 1)
    count = np.bincount(idx, minlength=n_bins).astype(np.float64)
    sum_p = np.bincount(idx, weights=p, minlength=n_bins)
    sum_y = np.bincount(idx, weights=y, minlength=n_bins)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_pred = np.where(count > 0, sum_p / count, np.nan)
        frac_pos = np.where(count > 0, sum_y / count, np.nan)
    return {
        "bin_mid": 0.5 * (edges[:-1] + edges[1:]),
        "mean_pred": mean_pred,
        "frac_pos": frac_pos,
        "count": count,
    }


def expected_calibration_error(p: np.ndarray, outcomes: np.ndarray,
                               n_bins: int = 10) -> float:
    """Count-weighted mean |mean_pred - frac_pos| over populated bins."""
    d = reliability_diagram(p, outcomes, n_bins=n_bins)
    pop = d["count"] > 0
    gaps = np.abs(d["mean_pred"][pop] - d["frac_pos"][pop])
    total = d["count"][pop].sum()
    return float((d["count"][pop] * gaps).sum() / total) if total else 0.0


def pattern_confusion(p: np.ndarray, truth: np.ndarray
                      ) -> Dict[str, float]:
    """Precision/recall/F1 of the nonzero-belief set vs. the
    nonzero-truth set — the Eq. 1 pattern metric.  Conventions:
    precision is 1.0 when nothing is predicted positive, recall is 1.0
    when the truth has no positives."""
    pred = _as_prob(p) > 0.0
    pos = _as_prob(truth) > 0.0
    tp = float(np.sum(pred & pos))
    fp = float(np.sum(pred & ~pos))
    fn = float(np.sum(~pred & pos))
    precision = tp / (tp + fp) if (tp + fp) else 1.0
    recall = tp / (tp + fn) if (tp + fn) else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "predicted_positive": tp + fp, "true_positive_rate": recall}


def window_outcomes(events: Sequence, n_nodes: int, horizon: float,
                    duration: float) -> np.ndarray:
    """Binary outcome matrix from a generated failure trace.

    Splits ``[0, horizon)`` into ``floor(horizon / duration)`` windows
    and marks ``out[w, i]`` True when node ``i`` has at least one
    ``fail`` event inside window ``w`` — the realized outcomes that
    :func:`brier_score` / :func:`log_loss` score a constant-horizon
    belief against.
    """
    n_windows = int(horizon // duration)
    out = np.zeros((max(n_windows, 0), n_nodes), dtype=bool)
    for ev in events:
        if ev.kind != "fail":
            continue
        w = int(ev.time // duration)
        if 0 <= w < n_windows:
            out[w, np.asarray(list(ev.nodes), dtype=np.int64)] = True
    return out


__all__ = [
    "brier_score", "log_loss", "belief_mse", "belief_mae",
    "reliability_diagram", "expected_calibration_error",
    "pattern_confusion", "window_outcomes",
]
