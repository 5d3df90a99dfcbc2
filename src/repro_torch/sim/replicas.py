"""Monte-Carlo replica engine: scenario presets across thousands of seeds.

Every gated claim of the reference package's ``benchmarks/clustersim.py``
used to rest on a single seed trajectory.  This module executes a
scenario preset across many independent seeds and aggregates the
per-policy metric distributions into bootstrap confidence intervals, so
the repo's paper-claim verification ("tofa < linear") is a *statistical*
statement instead of an anecdote::

    from repro_torch.sim.replicas import run_replicas
    rs  = run_replicas("saturated-queue", n_replicas=1000, fast=True)
    cmp = rs.compare()                  # paired tofa-vs-linear statistics
    assert cmp.delta_ci_low > 0         # 95% CI of mean(linear - tofa)

**Seed streams.**  Replica ``k`` runs ``run_preset(name, seed=seeds[k])``
— presets derive every RNG they use from that one seed through fixed
formulas, so each replica is bit-identical to a standalone
``run_preset(seed=k)`` call (asserted per preset in
``tests/test_torch_replicas.py``), and serial / process-pool / vectorized
execution all produce identical aggregates.

**Device.**  Every replica builds its engine on ``device`` (``cuda`` when
omitted, which raises
:class:`~repro_torch.core.backend.BackendUnavailableError` without a GPU;
``device="cpu"`` runs the plain PyTorch kernels).  Replica ``k`` equals
``run_preset(name, seed=k, device=device)`` in every execution mode.

**Execution modes.**

* ``executor="serial"`` — one replica at a time in-process.
* ``executor="process"`` — a :class:`concurrent.futures.
  ProcessPoolExecutor` over the seeds; workers return flat metric dicts
  (floats only), so results are identical to serial by construction.
  Preset kwargs must be picklable in this mode.  Workers are started
  with ``spawn``, never ``fork``: a forked child cannot use CUDA once the
  parent has initialised it, so each spawned worker imports the package
  afresh and builds its own engine on ``device``.
* ``executor="auto"`` — serial on a CUDA device (the replicas would
  share one card, each spawned worker with a CUDA context of its own);
  on the CPU, the process pool when it can help (> 1 CPU and at least 8
  replicas).
* the **vectorized paper path** — for ``paper-fig4-5`` (the paper-mode
  batch protocol: fixed per-batch placement, per-attempt Bernoulli
  draws, no checkpointing) the per-attempt failure draws are consumed as
  one uniform block per (batch, policy) and the geometric attempt/abort
  accounting is evaluated arithmetically, skipping the event heap
  entirely.  The block is a prefix of the exact RNG stream the event
  simulator would consume, so the completion times are *bit-identical*
  (wall-clock fields excepted).

**Statistics.**  :func:`bootstrap_ci` is a percentile bootstrap
(configurable resample count ``B`` and level ``alpha``) of a sample
statistic (the mean by default); :func:`summarize` wraps one metric
vector into a :class:`SummaryStats`; :meth:`ReplicaSet.compare` forms the
*paired* per-seed deltas between two policies and reports the delta CI,
the per-seed win rate, and a one-sided bootstrap p-value — the quantities
the benchmark gate consumes.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import multiprocessing
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.sim.scenarios import SCENARIOS, run_preset

# wall-clock fields: nondeterministic across runs, excluded from the
# bit-reproducibility contract (still aggregated, never gated)
WALL_CLOCK_KEYS = ("place_time_s",)


# ------------------------------------------------------------------ stats
def _norm_ppf(p: float) -> float:
    """Standard-normal quantile (Acklam's rational approximation,
    |relative error| < 1.15e-9 — scipy-free)."""
    if not (0.0 < p < 1.0):
        raise ValueError(f"p must be in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p_low = 0.02425
    if p < p_low:
        q = math.sqrt(-2.0 * math.log(p))
        return ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5])
                / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
    if p > 1.0 - p_low:
        q = math.sqrt(-2.0 * math.log(1.0 - p))
        return -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                  * q + c[5])
                 / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
    q = p - 0.5
    r = q * q
    return ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
             * r + a[5]) * q
            / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
               * r + 1.0))


def _norm_cdf(z: float) -> float:
    """Standard-normal CDF via ``math.erf``."""
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def _jackknife(x: np.ndarray, stat: Callable) -> np.ndarray:
    """Leave-one-out statistic values (vectorized for the mean — the
    replica engine's default — generic np.delete loop otherwise)."""
    n = x.size
    if stat is np.mean:
        return (x.sum() - x) / (n - 1)
    return np.array([float(stat(np.delete(x, i), axis=0))
                     for i in range(n)])


def bootstrap_ci(samples, B: int = 2000, alpha: float = 0.05,
                 seed: int = 0, stat: Callable = np.mean,
                 method: str = "percentile") -> tuple[float, float]:
    """Bootstrap confidence interval of ``stat(samples)``.

    Resamples ``samples`` with replacement ``B`` times and applies
    ``stat`` along the resample axis (``stat(x, axis=1)``).
    ``method="percentile"`` (default) returns the ``(alpha/2,
    1 - alpha/2)`` quantiles of the bootstrap distribution;
    ``method="bca"`` returns the bias-corrected-and-accelerated (BCa)
    interval — the same bootstrap sample read at quantile levels
    adjusted by the median-bias correction ``z0`` (normal quantile of
    the fraction of bootstrap values below the observed statistic) and
    the jackknife acceleration ``a`` (skewness of the leave-one-out
    statistics), which restores second-order-correct coverage on the
    small, skewed paired-delta samples the percentile interval
    under-covers (see the coverage test in ``tests/test_beliefs.py``).
    Degenerate inputs short-circuit for both methods: a single
    observation or an all-equal sample has a zero-width interval at the
    observed value.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError(f"samples must be 1-D, got shape {x.shape}")
    n = x.size
    if n == 0:
        raise ValueError("bootstrap_ci needs at least one sample")
    if not (0.0 < alpha < 1.0):
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")
    if method not in ("percentile", "bca"):
        raise ValueError(f"unknown bootstrap method {method!r}; "
                         "use 'percentile' or 'bca'")
    if n == 1 or np.ptp(x) == 0.0:
        v = float(stat(x, axis=0))
        return (v, v)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(B, n))
    boot = np.asarray(stat(x[idx], axis=1), dtype=np.float64)
    if method == "percentile":
        lo, hi = np.quantile(boot, [alpha / 2.0, 1.0 - alpha / 2.0])
        return (float(lo), float(hi))
    # BCa: bias correction from the bootstrap distribution's position
    # relative to the observed statistic, acceleration from the
    # jackknife skewness
    theta = float(stat(x, axis=0))
    frac_below = float((boot < theta).mean())
    frac_below = min(max(frac_below, 1.0 / (B + 1)), B / (B + 1.0))
    z0 = _norm_ppf(frac_below)
    jack = _jackknife(x, stat)
    dev = jack.mean() - jack
    denom = 6.0 * (dev ** 2).sum() ** 1.5
    accel = float((dev ** 3).sum() / denom) if denom > 0 else 0.0
    levels = []
    for z_a in (_norm_ppf(alpha / 2.0), _norm_ppf(1.0 - alpha / 2.0)):
        adj = z0 + (z0 + z_a) / (1.0 - accel * (z0 + z_a))
        levels.append(min(max(_norm_cdf(adj), 0.0), 1.0))
    lo, hi = np.quantile(boot, levels)
    return (float(lo), float(hi))


@dataclasses.dataclass(frozen=True)
class SummaryStats:
    """Distribution summary of one metric across replicas."""

    metric: str
    n: int
    mean: float
    std: float                  # sample std (ddof=1; 0.0 when n == 1)
    ci_low: float               # bootstrap CI of the mean (see ``method``)
    ci_high: float
    p05: float
    p50: float
    p95: float
    method: str = "percentile"  # bootstrap CI flavor: percentile | bca


def summarize(samples, metric: str = "", B: int = 2000,
              alpha: float = 0.05, seed: int = 0,
              method: str = "percentile") -> SummaryStats:
    """One metric vector -> :class:`SummaryStats` (bootstrap CI of the
    mean plus sample quantiles).  ``method="bca"`` opts into the
    bias-corrected-and-accelerated interval."""
    x = np.asarray(samples, dtype=np.float64)
    lo, hi = bootstrap_ci(x, B=B, alpha=alpha, seed=seed, method=method)
    q05, q50, q95 = np.quantile(x, [0.05, 0.50, 0.95])
    return SummaryStats(
        metric=metric, n=int(x.size), mean=float(x.mean()),
        std=float(x.std(ddof=1)) if x.size > 1 else 0.0,
        ci_low=lo, ci_high=hi,
        p05=float(q05), p50=float(q50), p95=float(q95), method=method)


@dataclasses.dataclass(frozen=True)
class PairedComparison:
    """Paired per-seed comparison of two policies on one metric.

    ``delta`` is ``mean(b - a)`` over seeds (positive == ``a`` smaller ==
    ``a`` better on completion-style metrics); ``delta_ci_low/high`` is
    the percentile-bootstrap CI of that paired mean; ``win_rate`` the
    fraction of seeds with ``a < b`` strictly; ``p_value`` the one-sided
    bootstrap p-value of ``mean(b - a) <= 0`` with the standard
    ``(k + 1) / (B + 1)`` small-sample correction.
    """

    metric: str
    a: str                      # the policy claimed better (smaller)
    b: str                      # the baseline
    n: int
    mean_a: float
    mean_b: float
    delta: float
    delta_ci_low: float
    delta_ci_high: float
    win_rate: float
    p_value: float
    method: str = "percentile"  # bootstrap CI flavor: percentile | bca

    @property
    def significant(self) -> bool:
        """The gate predicate: the whole delta CI is above zero."""
        return self.delta_ci_low > 0.0


def paired_compare(a_samples, b_samples, *, metric: str = "",
                   a: str = "a", b: str = "b", B: int = 2000,
                   alpha: float = 0.05, seed: int = 0,
                   method: str = "percentile") -> PairedComparison:
    """Paired bootstrap comparison: is ``mean(a) < mean(b)`` (same seeds)?

    ``method="bca"`` applies the BCa correction to the delta CI — small
    paired-delta samples are exactly where the percentile interval's
    coverage gets shaky (skewed deltas pull its endpoints inward)."""
    xa = np.asarray(a_samples, dtype=np.float64)
    xb = np.asarray(b_samples, dtype=np.float64)
    if xa.shape != xb.shape or xa.ndim != 1:
        raise ValueError(
            f"paired samples need matching 1-D shapes, got {xa.shape} vs "
            f"{xb.shape}")
    delta = xb - xa
    lo, hi = bootstrap_ci(delta, B=B, alpha=alpha, seed=seed, method=method)
    # one-sided p-value: bootstrap mass at or below zero
    if delta.size == 1 or np.ptp(delta) == 0.0:
        k = B if float(delta.mean()) <= 0.0 else 0
    else:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, delta.size, size=(B, delta.size))
        k = int((delta[idx].mean(axis=1) <= 0.0).sum())
    return PairedComparison(
        metric=metric, a=a, b=b, n=int(xa.size),
        mean_a=float(xa.mean()), mean_b=float(xb.mean()),
        delta=float(delta.mean()), delta_ci_low=lo, delta_ci_high=hi,
        win_rate=float((xa < xb).mean()),
        p_value=(k + 1) / (B + 1), method=method)


# ------------------------------------------------------- replica execution
def _flat_policy_rows(out: dict) -> dict[str, dict[str, float]]:
    """Flatten one preset result into ``{policy_key: {metric: value}}``.

    Nested presets (drain-sweep's per-threshold rows) flatten to
    ``"policy/th=<t>"`` keys; only scalar numerics survive (lists like
    ``batch_completions`` and booleans are summarised or dropped).
    """
    flat: dict[str, dict[str, float]] = {}

    def scalars(row: dict) -> dict[str, float]:
        vals = {}
        for k, v in row.items():
            if isinstance(v, bool):
                vals[k] = float(v)
            elif isinstance(v, (int, float, np.integer, np.floating)):
                vals[k] = float(v)
        return vals

    for pol, row in out["policies"].items():
        if "mean_completion" in row:
            flat[pol] = scalars(row)
        else:                       # nested (threshold-keyed) rows
            for th, r in row.items():
                flat[f"{pol}/th={th}"] = scalars(r)
    return flat


def _replica_worker(args) -> dict[str, dict[str, float]]:
    """Module-level so ProcessPoolExecutor can pickle it."""
    name, seed, policies, fast, device, preset_kw = args
    out = run_preset(name, seed=seed, policies=policies, fast=fast,
                     device=device, **preset_kw)
    return _flat_policy_rows(out)


def choose_executor(executor: str, device: torch.device, workers: int,
                    n_seeds: int) -> str:
    """``"serial"`` or ``"process"``: what :func:`run_replicas` runs for
    ``executor`` on the resolved ``device`` with ``workers`` processes.
    ``"auto"`` is serial on a CUDA device, and on the CPU pools when
    there is more than one worker and at least 8 seeds; a pool of one
    worker runs serially."""
    if executor == "auto":
        pooled = device.type == "cpu" and workers > 1 and n_seeds >= 8
    else:
        pooled = executor == "process"
    return "process" if pooled and workers > 1 else "serial"


@dataclasses.dataclass
class ReplicaSet:
    """Per-seed metric distributions of one preset across policies.

    ``metrics[policy_key][metric]`` is an (n_replicas,) array ordered as
    ``seeds`` — paired across policies, so per-seed deltas are meaningful.
    """

    preset: str
    fast: bool
    seeds: tuple[int, ...]
    policies: tuple[str, ...]
    metrics: dict[str, dict[str, np.ndarray]]

    @property
    def n_replicas(self) -> int:
        return len(self.seeds)

    def samples(self, policy: str, metric: str = "mean_completion"
                ) -> np.ndarray:
        try:
            return self.metrics[policy][metric]
        except KeyError:
            raise KeyError(
                f"no samples for policy={policy!r} metric={metric!r}; have "
                f"policies {sorted(self.metrics)} with metrics "
                f"{sorted(next(iter(self.metrics.values())))}") from None

    def summary(self, policy: str, metric: str = "mean_completion",
                B: int = 2000, alpha: float = 0.05, seed: int = 0,
                method: str = "percentile") -> SummaryStats:
        return summarize(self.samples(policy, metric), metric=metric,
                         B=B, alpha=alpha, seed=seed, method=method)

    def compare(self, a: str = "tofa", b: str = "linear",
                metric: str = "mean_completion", B: int = 2000,
                alpha: float = 0.05, seed: int = 0,
                method: str = "percentile") -> PairedComparison:
        """Paired per-seed comparison (default: tofa vs. linear)."""
        return paired_compare(
            self.samples(a, metric), self.samples(b, metric),
            metric=metric, a=a, b=b, B=B, alpha=alpha, seed=seed,
            method=method)


class _StreamingCollector:
    """Streams per-replica flat rows straight into preallocated
    per-policy metric arrays.

    The old collector held every replica's flat result dict alive until
    the end of the run — O(n_replicas * policies * metrics) Python
    floats, dict and string overhead included, which at 1k seeds
    dominated the resident set of the replica engine.  This one
    allocates the final (n_replicas,) float64 arrays from the first row
    and writes each subsequent row into its seed slot as it arrives, so
    at any instant only one flat row is alive regardless of replica
    count.  Execution modes that yield rows in seed order (serial,
    ``pool.map``, the vectorized path) stream through :meth:`add`
    unchanged.
    """

    def __init__(self, n_replicas: int):
        self._n = n_replicas
        self._metrics: Optional[dict[str, dict[str, np.ndarray]]] = None

    def add(self, k: int, row: dict[str, dict[str, float]]) -> None:
        """Record replica ``k``'s flat ``{policy: {metric: value}}``."""
        if self._metrics is None:
            self._metrics = {
                pol: {m: np.empty(self._n, dtype=np.float64) for m in vals}
                for pol, vals in row.items()}
        for pol, vals in row.items():
            dest = self._metrics[pol]
            for m, v in vals.items():
                dest[m][k] = v

    def result(self) -> dict[str, dict[str, np.ndarray]]:
        return self._metrics if self._metrics is not None else {}


def run_replicas(
    name: str,
    *,
    n_replicas: Optional[int] = None,
    seeds: Optional[Sequence[int]] = None,
    base_seed: int = 0,
    policies: Sequence[str] = ("linear", "tofa"),
    fast: bool = False,
    executor: str = "auto",
    max_workers: Optional[int] = None,
    vectorize: str = "auto",
    device: Optional[str] = None,
    **preset_kw,
) -> ReplicaSet:
    """Execute preset ``name`` across independent seeds and collect the
    per-policy metric distributions.

    ``seeds`` gives the replica seeds explicitly; otherwise
    ``base_seed + arange(n_replicas)``.  ``executor`` is ``"serial"``,
    ``"process"`` (seed-parallel worker pool, ``max_workers`` processes)
    or ``"auto"`` (process pool when it can help: > 1 CPU and enough
    replicas to amortise worker startup; always serial on a CUDA device,
    see :func:`choose_executor`).  ``max_workers=None`` or ``0``
    auto-detects ``os.cpu_count()``.  ``device`` is where every replica's
    engine places (``cuda`` when omitted).  ``vectorize`` enables the
    bit-identical closed-form paper-mode path for ``paper-fig4-5``
    (``"auto"``/``"always"``/``"never"``).

    Results stream into preallocated per-metric arrays as replicas
    finish (:class:`_StreamingCollector`) — memory is O(n_replicas)
    floats per metric, never n_replicas live result dicts.

    Replica ``k`` is bit-identical to ``run_preset(name, seed=seeds[k])``
    regardless of the execution mode (wall-clock fields excepted).
    """
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    if (n_replicas is None) == (seeds is None):
        raise ValueError("pass exactly one of n_replicas / seeds")
    if seeds is None:
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        seeds = range(base_seed, base_seed + n_replicas)
    seeds = tuple(int(s) for s in seeds)
    policies = tuple(policies)
    if executor not in ("auto", "serial", "process"):
        raise ValueError(f"unknown executor {executor!r}")
    dev = resolve_device("cuda" if device is None else device)
    if vectorize not in ("auto", "always", "never"):
        raise ValueError(f"unknown vectorize {vectorize!r}")

    use_vector = (name == "paper-fig4-5" and vectorize != "never")
    if vectorize == "always" and name != "paper-fig4-5":
        raise ValueError(
            f"vectorized execution only covers 'paper-fig4-5', not {name!r}")

    collect = _StreamingCollector(len(seeds))
    if use_vector:
        for k, s in enumerate(seeds):
            collect.add(k, _flat_policy_rows(
                paper_replica_vector(seed=s, policies=policies, fast=fast,
                                     device=device, **preset_kw)))
        return ReplicaSet(name, fast, seeds, policies, collect.result())

    workers = max_workers or (os.cpu_count() or 1)
    args = [(name, s, policies, fast, device, preset_kw) for s in seeds]
    if choose_executor(executor, dev, workers, len(seeds)) == "process":
        with concurrent.futures.ProcessPoolExecutor(
                workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            # pool.map yields in seed order, so rows stream straight
            # into their slots without buffering the full result list
            for k, row in enumerate(
                    pool.map(_replica_worker, args,
                             chunksize=max(1, len(seeds) // (4 * workers)))):
                collect.add(k, row)
    else:
        for k, a in enumerate(args):
            collect.add(k, _replica_worker(a))
    return ReplicaSet(name, fast, seeds, policies, collect.result())


# -------------------------------------------- vectorized paper-mode path
def paper_replica_vector(
    seed: int = 0,
    policies: Sequence[str] = ("linear", "tofa"),
    fast: bool = False,
    wl_factory=None,
    dims: tuple[int, ...] = (8, 8, 8),
    n_batches: int = 10,
    n_instances: int = 100,
    n_faulty: int = 16,
    p_f: float = 0.02,
    scheduler_knows_truth: bool = True,
    topology=None,
    max_attempts: int = 100,
    device: Optional[str] = None,
) -> dict:
    """One ``paper-fig4-5`` replica via block-drawn failure uniforms.

    Mirrors :func:`repro_torch.sim.scenarios.paper_fig4_5` **bit-for-bit**
    on every stochastic output: the placement call consumes the per-(batch,
    policy) RNG exactly as the preset does, then the per-attempt
    Bernoulli draws are taken as one ``rng.random((K, n_faulty))`` block
    — row ``r`` of the block is byte-identical to the ``r``-th sequential
    ``sample_failed`` draw, so doom decisions, attempt counts, abort
    counts, event counts and (sequentially accumulated) makespans all
    match the event simulator.  Only ``place_time_s`` (wall-clock)
    differs run to run, as it does between any two event-sim runs.
    The engine places on ``device`` (``cuda`` when omitted).
    """
    from repro_torch.core.engine import PlacementEngine, PlacementRequest
    from repro_torch.core.state import ClusterState
    from repro_torch.core.topology import TorusTopology
    from repro_torch.cluster.failures import BernoulliPerJob
    from repro_torch.sim.jobsim import successful_runtime
    from repro_torch.sim.network import network_for
    from repro_torch.workloads.patterns import npb_dt_like

    if fast:
        dims, n_batches, n_instances, n_faulty = (4, 4, 4), 2, 20, 8
        wl_factory = wl_factory or (lambda: npb_dt_like(24))
    wl_factory = wl_factory or (lambda: npb_dt_like(85))
    topo = topology if topology is not None else TorusTopology(dims)
    net = network_for(topo)
    engine = PlacementEngine(device=device)
    comps: dict[str, list[float]] = {p: [] for p in policies}
    aborts: dict[str, int] = {p: 0 for p in policies}
    events: dict[str, int] = {p: 0 for p in policies}
    place_time: dict[str, float] = {p: 0.0 for p in policies}
    for b in range(n_batches):
        batch_rng = np.random.default_rng(seed * 1000 + b)
        candidates = batch_rng.choice(topo.n_nodes, n_faulty, replace=False)
        fm = BernoulliPerJob(candidates, p_f)
        known = (fm.outage_vector(topo.n_nodes)
                 if scheduler_knows_truth else None)
        wl = wl_factory()
        known_state = ClusterState.from_arrays(topo.n_nodes, p_f=known)
        for pol in policies:
            rng = np.random.default_rng(seed * 7777 + b)
            plan = engine.place(
                PlacementRequest(comm=wl.comm, topology=topo,
                                 state=known_state),
                policy=pol, rng=rng)
            place_time[pol] += plan.wall_time_s
            t_ok = successful_runtime(wl, plan.placement, net)
            # which candidates doom an attempt at all: monotone
            # union-of-singletons form of touches_failed
            touch = np.array([
                net.touches_failed(wl.comm, plan.placement,
                                   np.array([c], dtype=np.int64))
                for c in candidates])
            n_att, n_ab = _walk_attempts(rng, touch, p_f, n_instances,
                                         max_attempts)
            t = 0.0                  # sequential accumulation, as the
            for _ in range(n_att):   # event heap adds one t_ok per attempt
                t += t_ok
            comps[pol].append(t)
            aborts[pol] += n_ab
            events[pol] += 2 * n_instances + 2 * n_ab
    rows = {
        pol: {
            "mean_completion": float(np.mean(comps[pol])),
            "batch_completions": comps[pol],
            "aborted_attempts": int(aborts[pol]),
            "n_events": int(events[pol]),
            "place_time_s": place_time[pol],
        } for pol in policies}
    return {"name": "paper-fig4-5",
            "params": {"dims": getattr(topo, "dims", None),
                       "n_batches": n_batches, "n_instances": n_instances,
                       "n_faulty": n_faulty, "p_f": p_f, "seed": seed},
            "policies": rows}


def _walk_attempts(rng: np.random.Generator, touch: np.ndarray,
                   p_f: float, n_instances: int, max_attempts: int
                   ) -> tuple[int, int]:
    """Consume per-attempt failure uniforms in blocks and walk the serial
    instance chain: returns (total attempts, total aborted attempts).

    Every row of every drawn block corresponds 1:1 to one sequential
    ``BernoulliPerJob.sample_failed`` call (numpy Generators fill arrays
    from the stream in row-major order), so the doom sequence is exactly
    the event simulator's.  Over-drawn rows past the last consumed
    attempt are never used by anyone — the RNG is not consumed again.
    """
    C = touch.size
    q = p_f * float(touch.sum())          # rough per-attempt doom rate
    block = max(32, int(math.ceil(n_instances * (1.0 + 3.0 * q))))
    doom = np.zeros(0, dtype=bool)
    cursor = 0
    aborted = 0
    for _ in range(n_instances):
        attempts = 0
        while True:
            if cursor >= doom.size:
                u = rng.random((block, C))
                fresh = (u < p_f) & touch[None, :]
                doom = np.concatenate([doom, fresh.any(axis=1)])
            attempts += 1
            doomed = doom[cursor] and attempts < max_attempts
            cursor += 1
            if not doomed:
                break
            aborted += 1
    return cursor, aborted
