"""The port's scenario presets against the reference's, bit for bit.

Every preset of ``repro_torch.sim.scenarios.SCENARIOS`` runs on
``device="cpu"`` and must return the reference preset's result dict with
the same seed, field for field; only the mapper's wall-clock
``place_time_s`` may differ.  One batch of ``paper-fig4-5`` runs at the
paper's full protocol size (8x8x8 torus, ``npb_dt_like(85)``, 100
instances, 16 faulty candidates).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import PlacementEngine as RefEngine  # noqa: E402
from repro.sim import scenarios as R_scen  # noqa: E402
from repro.workloads.patterns import lammps_like as ref_lammps  # noqa: E402

from repro_torch.core import backend  # noqa: E402
from repro_torch.core.engine import PlacementEngine  # noqa: E402
from repro_torch.sim import scenarios as T_scen  # noqa: E402
from repro_torch.workloads.patterns import lammps_like  # noqa: E402

WALL = {"place_time_s"}


def strip(x):
    """A preset's result dict without its wall-clock fields (NaN made
    comparable)."""
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, (list, tuple)):
        return [strip(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def test_same_presets():
    assert list(T_scen.SCENARIOS) == list(R_scen.SCENARIOS)
    assert len(T_scen.SCENARIOS) == 10
    assert T_scen.BELIEF_MODES == R_scen.BELIEF_MODES


@pytest.mark.parametrize("name", list(R_scen.SCENARIOS))
def test_fast_preset_matches(name):
    got = T_scen.run_preset(name, fast=True, device="cpu")
    want = R_scen.run_preset(name, fast=True)
    assert strip(got) == strip(want)
    rows = got["policies"]
    assert set(rows) == {"linear", "tofa"}
    for row in rows.values():
        for r in (row.values() if name == "drain-sweep" else [row]):
            assert r["place_time_s"] >= 0.0


@pytest.mark.parametrize("mode", list(R_scen.BELIEF_MODES))
def test_belief_modes_match(mode):
    """``belief_mode`` reaches the port's own ``beliefs`` package."""
    kw = dict(policies=("tofa",), fast=True, belief_mode=mode)
    got = T_scen.run_preset("correlated-failures", device="cpu", **kw)
    want = R_scen.run_preset("correlated-failures", **kw)
    assert strip(got) == strip(want)
    if mode != "monitor":
        assert "belief_err" in got["policies"]["tofa"]


def test_preset_takes_the_callers_engine():
    """An ``engine=`` given by the caller wins over ``device``, as in the
    reference, and its caches see the preset's placements."""
    eng = PlacementEngine(device="cpu")
    got = T_scen.run_preset("drain-sweep", fast=True, engine=eng,
                            policies=("tofa",), thresholds=(0.5,))
    want = R_scen.run_preset("drain-sweep", fast=True, engine=RefEngine(),
                             policies=("tofa",), thresholds=(0.5,))
    assert strip(got) == strip(want)
    assert eng.cache_stats()["weight_misses"] > 0


def test_paper_protocol_full_size_batch():
    """One batch of the paper's Section 5.2 protocol at full size: 85-rank
    NPB-DT on the 8x8x8 torus, 100 instances, 16 faulty candidates."""
    got = T_scen.run_preset("paper-fig4-5", n_batches=1, device="cpu")
    want = R_scen.run_preset("paper-fig4-5", n_batches=1)
    assert strip(got) == strip(want)
    rows = got["policies"]
    assert rows["tofa"]["mean_completion"] < rows["linear"]["mean_completion"]


def test_paper_protocol_other_workload():
    """``wl_factory`` reaches the port's preset: 32-rank LAMMPS (integer
    guest weights, like the paper's 64-rank run) on the 4x4x4 torus."""
    kw = dict(dims=(4, 4, 4), n_batches=2, n_instances=20, n_faulty=8)
    got = T_scen.run_preset("paper-fig4-5", device="cpu",
                            wl_factory=lambda: lammps_like(32), **kw)
    want = R_scen.run_preset("paper-fig4-5",
                             wl_factory=lambda: ref_lammps(32), **kw)
    assert strip(got) == strip(want)


@pytest.mark.parametrize("name", ["paper-fig4-5", "saturated-queue",
                                  "fat-tree", "dragonfly"])
def test_presets_target_the_card(monkeypatch, name):
    """Without ``device`` (or an engine) a preset builds its engine on
    ``cuda``: with no GPU it raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    with pytest.raises(backend.BackendUnavailableError):
        T_scen.run_preset(name, fast=True)
    with pytest.raises(KeyError):
        T_scen.run_preset("no-such-preset", device="cpu")
