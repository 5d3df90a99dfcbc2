"""Arrival processes and job-mix factories for the cluster simulator.

A *job stream* is a list of :class:`JobSpec`: what to run (a
:class:`~repro_torch.workloads.patterns.Workload` plus an srun distribution
policy) and when it enters the system.  ``submit_time`` is absolute
simulated seconds; ``after_previous=True`` instead chains the job behind
the previous spec in the stream (submitted the instant it completes) —
the *serial* arrival discipline of the paper's batch protocol, where a
batch is 100 instances of the same application run back-to-back.

Job mixes model what the paper's single-application batches cannot: a
scheduler facing jobs of different widths and communication patterns at
once, where queueing and backfill decisions interact with placement.

All draws take an explicit ``numpy.random.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.workloads.patterns import (Workload, halo3d, lammps_like,
                                      npb_dt_like)


@dataclasses.dataclass
class JobSpec:
    """One job in a stream: payload, policy, and arrival semantics."""

    workload: Workload
    policy: str = "tofa"
    submit_time: float = 0.0            # absolute seconds (ignored if chained)
    after_previous: bool = False        # serial chaining: submit on prev done
    fixed_placement: Optional[np.ndarray] = None  # bypass the scheduler
    name: Optional[str] = None

    def label(self) -> str:
        return self.name or self.workload.name


def serial_stream(workloads: Sequence[Workload], policy: str = "tofa",
                  fixed_placement: Optional[np.ndarray] = None
                  ) -> list[JobSpec]:
    """The paper's batch discipline: instance i+1 is submitted the moment
    instance i completes.  With ``fixed_placement`` every instance reuses
    one placement (the paper computes placement once per batch)."""
    if not workloads:
        raise ValueError("serial_stream needs at least one workload")
    out = []
    for i, wl in enumerate(workloads):
        out.append(JobSpec(wl, policy=policy, submit_time=0.0,
                           after_previous=(i > 0),
                           fixed_placement=fixed_placement,
                           name=f"{wl.name}#{i}"))
    return out


def burst_stream(workloads: Sequence[Workload], policy: str = "tofa",
                 at: float = 0.0) -> list[JobSpec]:
    """Saturation discipline: every job submitted at the same instant —
    the queue starts full and drains against capacity."""
    if not workloads:
        raise ValueError("burst_stream needs at least one workload")
    if at < 0:
        raise ValueError(f"submit instant must be >= 0, got {at}")
    return [JobSpec(wl, policy=policy, submit_time=at, name=f"{wl.name}#{i}")
            for i, wl in enumerate(workloads)]


def poisson_stream(workload_factory: Callable[[np.random.Generator],
                                              Workload],
                   rate: float, n_jobs: int, rng: np.random.Generator,
                   policy: str = "tofa",
                   max_duration: Optional[float] = None) -> list[JobSpec]:
    """Open-arrival discipline: exponential inter-arrival times with mean
    ``1 / rate`` jobs/second; each job drawn from ``workload_factory``.

    ``max_duration`` caps the arrival window in simulated seconds: the
    stream stops at the first arrival past the cap (so it may hold fewer
    than ``n_jobs`` specs) — the storm benchmark uses this to bound an
    open-loop run independently of the sampled inter-arrival draws."""
    if not (rate > 0) or not np.isfinite(rate):
        raise ValueError(f"arrival rate must be a finite value > 0 "
                         f"jobs/second, got {rate}")
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    if max_duration is not None and max_duration <= 0:
        raise ValueError(f"max_duration must be > 0, got {max_duration}")
    t = 0.0
    out = []
    for i in range(n_jobs):
        t += float(rng.exponential(1.0 / rate))
        if max_duration is not None and t > max_duration:
            break
        wl = workload_factory(rng)
        out.append(JobSpec(wl, policy=policy, submit_time=t,
                           name=f"{wl.name}#{i}"))
    return out


def mixed_size_factory(sizes: Sequence[int] = (8, 27, 64),
                       weights: Sequence[float] | None = None,
                       ) -> Callable[[np.random.Generator], Workload]:
    """Job-mix factory: each draw picks a width from ``sizes`` and a
    pattern (regular halo vs irregular DAG) at random — small frequent
    jobs alongside wide rare ones, the mix that exercises backfill."""
    sizes = list(sizes)
    if not sizes:
        raise ValueError("mixed_size_factory needs at least one size")
    w = None if weights is None else np.asarray(weights, float)
    if w is not None:
        if len(w) != len(sizes) or (w < 0).any() or w.sum() <= 0:
            raise ValueError(
                f"weights must be {len(sizes)} nonnegative values with a "
                f"positive sum")
        w = w / w.sum()

    def factory(rng: np.random.Generator) -> Workload:
        n = int(rng.choice(sizes, p=w))
        if rng.random() < 0.5:
            dims = _near_cube(n)
            return halo3d(dims)
        return npb_dt_like(n, seed=int(rng.integers(1 << 31)))
    return factory


def replicated(wl_factory: Callable[[], Workload], n: int) -> list[Workload]:
    """n instances of one application — the paper's batch composition."""
    return [wl_factory() for _ in range(n)]


def _near_cube(n: int) -> tuple[int, int, int]:
    """Most cubic (a, b, c) with a*b*c == n (fallback (1, 1, n))."""
    best = (1, 1, n)
    for a in range(1, int(round(n ** (1 / 3))) + 2):
        if n % a:
            continue
        m = n // a
        for b in range(a, int(m ** 0.5) + 2):
            if m % b == 0 and m // b >= b:
                if max(a, b, m // b) - a < max(best) - best[0]:
                    best = (a, b, m // b)
    return best


__all__ = ["JobSpec", "serial_stream", "burst_stream", "poisson_stream",
           "mixed_size_factory", "replicated", "lammps_like", "npb_dt_like"]
