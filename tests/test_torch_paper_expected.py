"""``chip_smoke.py``'s paper-phase constants are the reference's results.

The card's ``paper`` phase holds the port's ``paper-fig4-5`` preset to
``EXPECTED_PAPER`` (85-rank NPB-DT at the paper's full protocol, 64-rank
LAMMPS at 3 batches) and the scheduler's elastic re-placement to
``EXPECTED_ELASTIC``.  These tests recompute both with the reference
package's NumPy engine, and run the elastic re-placement on the port's
engine on the CPU against the same constants.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster.scheduler import Job as RefJob  # noqa: E402
from repro.cluster.scheduler import Scheduler as RefScheduler  # noqa: E402
from repro.core.topology import TorusTopology as RefTorus  # noqa: E402
from repro.sim.scenarios import run_preset as ref_run_preset  # noqa: E402
from repro.workloads.patterns import lammps_like as ref_lammps  # noqa: E402

from repro_torch.cluster.scheduler import Job, Scheduler  # noqa: E402
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.workloads.patterns import lammps_like  # noqa: E402


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["npb_dt-85", "lammps-64"])
def test_expected_paper_is_the_reference(cell):
    cs = _chip_smoke()
    kw = ({} if cell == "npb_dt-85"
          else {"n_batches": 3, "wl_factory": lambda: ref_lammps(64)})
    out = ref_run_preset("paper-fig4-5", policies=("linear", "tofa"),
                         seed=0, **kw)
    assert out["params"]["dims"] == (8, 8, 8)
    assert out["params"]["n_instances"] == 100
    rows = out["policies"]
    got = {pol: {k: rows[pol][k] for k in cs.PAPER_FIELDS} for pol in rows}
    assert got == cs.EXPECTED_PAPER[cell]
    assert rows["tofa"]["mean_completion"] < rows["linear"]["mean_completion"]


def _elastic(sch, job):
    sch.heartbeat_round(np.ones(512, dtype=bool))
    rec = sch.submit(job)
    victim = int(rec.placement.placement[10])
    before = rec.placement.hop_bytes
    affected = sch.handle_node_failure([victim])
    plan = rec.placement
    assert len(affected) == 1 and rec.restarts == 1
    assert victim not in set(plan.placement.tolist())
    return {"victim": victim, "hop_bytes_before": before,
            "hop_bytes": plan.hop_bytes, "provenance": plan.provenance,
            "placement": plan.placement.tolist()}


def test_expected_elastic_is_the_reference():
    got = _elastic(RefScheduler(RefTorus((8, 8, 8))),
                   RefJob(ref_lammps(64), distribution="tofa"))
    assert got == _chip_smoke().EXPECTED_ELASTIC


def test_port_elastic_replacement_equals_the_constants():
    """The port's scheduler, on its engine on the CPU, re-places exactly
    as the card must."""
    got = _elastic(Scheduler(TorusTopology((8, 8, 8)), device="cpu"),
                   Job(lammps_like(64), distribution="tofa"))
    assert got == _chip_smoke().EXPECTED_ELASTIC
