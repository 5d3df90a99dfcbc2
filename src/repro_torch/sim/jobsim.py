"""Single-job simulation: completion time + abort decision for one instance.

**Units.**  All returned times are *simulated seconds* under the network
model's platform constants (the paper's SimGrid platform: 6 Gflops
nodes, 10 Gbps / 1 usec links).  They are physical only to the extent
those constants are; relative comparisons between placements are the
meaningful output.  Byte and flop inputs come from
:class:`~repro_torch.workloads.patterns.Workload` and are totals per run.

**Determinism.**  Nothing here draws randomness: an instance outcome is
a pure function of (workload, placement, network, failed set).  All
stochastic choice — which nodes fail, where an attempt aborts — lives in
the callers (:mod:`repro_torch.sim.batchsim`, :mod:`repro_torch.sim.clustersim`) and
flows through their explicit ``numpy.random.Generator`` arguments, so a
batch or event-sim run is reproducible from its seed.

**Truth vs estimate.**  ``failed`` is *ground truth* (sampled from a
:class:`~repro_torch.cluster.failures.FailureModel`).  The scheduler-side
belief (``known_p_f`` in :func:`repro_torch.sim.batchsim.run_batch`) never
reaches this module: placement quality is decided upstream, the physics
here only ask "did a truly-failed node touch the job?".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.network import TorusNetwork
from repro_torch.workloads.patterns import Workload


@dataclasses.dataclass
class JobOutcome:
    completed: bool
    time: float                # successful runtime (time charged on abort too)
    aborted_by: np.ndarray     # failed nodes that killed it (empty if ok)


def successful_runtime(wl: Workload, placement: np.ndarray,
                       net: TorusNetwork) -> float:
    """Failure-free runtime in simulated seconds: compute + communication
    (no overlap — the conservative model; overlap is a serving-framework
    concern, not the placement paper's).  ``net`` may be any network
    model exposing ``compute_time`` / ``comm_time``
    (:class:`~repro_torch.sim.network.TorusNetwork`,
    :class:`~repro_torch.sim.network.HopNetwork`)."""
    return net.compute_time(wl.flops_per_rank, wl.rounds) \
        + net.comm_time(wl.comm, placement)


def simulate_instance(
    wl: Workload,
    placement: np.ndarray,
    net: TorusNetwork,
    failed: np.ndarray,
    runtime: float | None = None,
) -> JobOutcome:
    """One scenario: if any failed node is an endpoint or on a used route,
    the MPI job aborts (paper fault model: failed nodes neither compute nor
    forward; communication errors abort the job).

    ``failed`` holds ground-truth failed node ids for this one attempt.
    ``runtime`` (seconds) overrides the charged time when the caller
    tracks partial progress (checkpoint/restart accounting in
    ``run_batch``); default is the full :func:`successful_runtime`.
    """
    t = successful_runtime(wl, placement, net) if runtime is None else runtime
    if len(failed) and net.touches_failed(wl.comm, placement, failed):
        return JobOutcome(False, t, np.asarray(failed))
    return JobOutcome(True, t, np.array([], dtype=np.int64))
