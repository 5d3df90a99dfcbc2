"""The port's Monte-Carlo replica engine against the reference's.

Mirrors ``tests/test_replicas.py`` on ``repro_torch.sim.replicas`` with
every engine on ``device="cpu"``: the bootstrap and paired statistics,
every replica equal to a standalone ``run_preset`` call, the process pool
equal to serial execution, the vectorized paper path equal to the event
path, and the pinned fat-tree-32 summary.  Then the port's replicas equal
the reference's on the same seeds, and ``executor="auto"`` runs serially
when the device is a CUDA device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim import replicas as R_rep  # noqa: E402

from repro_torch.core import backend  # noqa: E402
from repro_torch.sim.replicas import (  # noqa: E402
    PairedComparison, ReplicaSet, SummaryStats, bootstrap_ci,
    choose_executor, paired_compare, paper_replica_vector, run_replicas,
    summarize, _flat_policy_rows,
)
from repro_torch.sim.scenarios import SCENARIOS, run_preset  # noqa: E402

CPU = "cpu"


# ------------------------------------------------------------ statistics
def test_bootstrap_ci_matches_normal_theory():
    rng = np.random.default_rng(0)
    x = rng.normal(loc=3.0, scale=2.0, size=400)
    lo, hi = bootstrap_ci(x, B=4000, alpha=0.05, seed=1)
    se = x.std(ddof=1) / np.sqrt(x.size)
    assert lo < x.mean() < hi
    assert lo == pytest.approx(x.mean() - 1.96 * se, abs=0.6 * se)
    assert hi == pytest.approx(x.mean() + 1.96 * se, abs=0.6 * se)


def test_bootstrap_ci_level_monotone():
    rng = np.random.default_rng(3)
    x = rng.exponential(size=200)
    lo95, hi95 = bootstrap_ci(x, B=2000, alpha=0.05, seed=2)
    lo50, hi50 = bootstrap_ci(x, B=2000, alpha=0.50, seed=2)
    assert lo95 <= lo50 <= hi50 <= hi95


def test_bootstrap_ci_degenerate_inputs():
    assert bootstrap_ci([4.2]) == (4.2, 4.2)
    assert bootstrap_ci([1.5] * 10) == (1.5, 1.5)
    lo, hi = bootstrap_ci([1.0, 2.0], B=200, seed=0)
    assert 1.0 <= lo <= hi <= 2.0
    with pytest.raises(ValueError):
        bootstrap_ci([])
    with pytest.raises(ValueError):
        bootstrap_ci([1.0, 2.0], alpha=1.5)
    with pytest.raises(ValueError):
        bootstrap_ci([1.0, 2.0], B=0)
    with pytest.raises(ValueError):
        bootstrap_ci(np.zeros((2, 2)))


def test_bootstrap_ci_seed_reproducible():
    x = np.random.default_rng(5).normal(size=50)
    assert bootstrap_ci(x, seed=9) == bootstrap_ci(x, seed=9)
    assert bootstrap_ci(x, seed=9) != bootstrap_ci(x, seed=10)


def test_summarize_fields_consistent():
    x = np.random.default_rng(1).normal(size=100)
    s = summarize(x, metric="m", B=500, alpha=0.05, seed=0)
    assert isinstance(s, SummaryStats)
    assert s.metric == "m" and s.n == 100
    assert s.ci_low <= s.mean <= s.ci_high
    assert s.p05 <= s.p50 <= s.p95
    assert s.std == pytest.approx(x.std(ddof=1))
    assert summarize([7.0]).std == 0.0


def test_paired_compare_detects_shift():
    rng = np.random.default_rng(2)
    b = rng.normal(loc=5.0, scale=1.0, size=64)
    a = b - rng.uniform(0.5, 1.5, size=64)
    cmp = paired_compare(a, b, a="tofa", b="linear", B=1000, seed=0)
    assert isinstance(cmp, PairedComparison)
    assert cmp.significant and cmp.delta_ci_low > 0
    assert cmp.win_rate == 1.0
    assert cmp.p_value <= 2 / 1001
    assert cmp.delta == pytest.approx(float((b - a).mean()))


def test_paired_compare_null_not_significant():
    x = np.random.default_rng(4).normal(size=64)
    cmp = paired_compare(x, x, B=500)
    assert cmp.delta == 0.0 and not cmp.significant
    assert cmp.win_rate == 0.0 and cmp.p_value > 0.5
    with pytest.raises(ValueError):
        paired_compare([1.0, 2.0], [1.0])


@pytest.mark.parametrize("method", ["percentile", "bca"])
def test_statistics_equal_reference(method):
    """The copied statistics give the reference's numbers exactly."""
    rng = np.random.default_rng(8)
    a, b = rng.exponential(size=40), rng.exponential(size=40) + 0.1
    assert bootstrap_ci(a, B=500, seed=3, method=method) == \
        R_rep.bootstrap_ci(a, B=500, seed=3, method=method)
    assert summarize(a, "m", B=500, method=method) == \
        SummaryStats(**vars(R_rep.summarize(a, "m", B=500, method=method)))
    assert paired_compare(a, b, B=500, method=method) == PairedComparison(
        **vars(R_rep.paired_compare(a, b, B=500, method=method)))


# ----------------------------------------------------------- determinism
def _strip_wall(rows):
    return {pol: {k: v for k, v in r.items() if k != "place_time_s"}
            for pol, r in rows.items()}


@pytest.mark.parametrize("preset", sorted(SCENARIOS))
def test_replica_bit_identical_to_standalone(preset):
    seed = 11
    rs = run_replicas(preset, seeds=[seed], fast=True, device=CPU)
    ref = _strip_wall(_flat_policy_rows(run_preset(preset, seed=seed,
                                                   fast=True, device=CPU)))
    for pol, row in ref.items():
        for k, v in row.items():
            assert rs.metrics[pol][k][0] == v, (preset, pol, k)


def test_process_pool_equals_serial():
    """The spawned pool (each worker builds its engine on the CPU) gives
    what serial execution gives."""
    a = run_replicas("fat-tree", n_replicas=4, fast=True, executor="serial",
                     device=CPU)
    b = run_replicas("fat-tree", n_replicas=4, fast=True,
                     executor="process", max_workers=2, device=CPU)
    assert a.seeds == b.seeds and a.policies == b.policies
    for pol in a.metrics:
        for k in a.metrics[pol]:
            if k == "place_time_s":
                continue
            assert np.array_equal(a.metrics[pol][k], b.metrics[pol][k])


def test_vectorized_paper_path_equals_event_path():
    vec = run_replicas("paper-fig4-5", n_replicas=3, fast=True, device=CPU)
    evt = run_replicas("paper-fig4-5", n_replicas=3, fast=True,
                       vectorize="never", device=CPU)
    for pol in vec.metrics:
        for k in vec.metrics[pol]:
            if k == "place_time_s":
                continue
            assert np.array_equal(vec.metrics[pol][k],
                                  evt.metrics[pol][k]), (pol, k)


def test_vectorized_single_replica_matches_standalone():
    ref = _strip_wall(_flat_policy_rows(run_preset("paper-fig4-5", seed=4,
                                                   fast=True, device=CPU)))
    vec = _strip_wall(_flat_policy_rows(paper_replica_vector(
        seed=4, fast=True, device=CPU)))
    assert vec == ref


# ------------------------------------------------------------- aggregate
def test_replicaset_compare_and_summary():
    rs = run_replicas("dragonfly", n_replicas=6, fast=True, device=CPU)
    assert isinstance(rs, ReplicaSet) and rs.n_replicas == 6
    s = rs.summary("tofa")
    assert s.n == 6 and s.ci_low <= s.mean <= s.ci_high
    cmp = rs.compare(B=500)
    assert cmp.a == "tofa" and cmp.b == "linear" and cmp.n == 6
    assert 0.0 <= cmp.win_rate <= 1.0
    assert cmp.delta_ci_low <= cmp.delta <= cmp.delta_ci_high
    with pytest.raises(KeyError):
        rs.samples("no-such-policy")


def test_run_replicas_argument_validation():
    with pytest.raises(KeyError):
        run_replicas("no-such-preset", n_replicas=1, device=CPU)
    with pytest.raises(ValueError):
        run_replicas("fat-tree", device=CPU)
    with pytest.raises(ValueError):
        run_replicas("fat-tree", n_replicas=2, seeds=[0, 1], device=CPU)
    with pytest.raises(ValueError):
        run_replicas("fat-tree", n_replicas=0, device=CPU)
    with pytest.raises(ValueError):
        run_replicas("fat-tree", n_replicas=1, executor="threads",
                     device=CPU)
    with pytest.raises(ValueError):
        run_replicas("fat-tree", n_replicas=1, vectorize="always",
                     device=CPU)


PINNED = {
    # tests/test_replicas.py's pinned values: run_replicas("fat-tree",
    # n_replicas=32, fast=True), summary(B=1000, seed=0) /
    # compare(B=1000, seed=0)
    "tofa_mean": 0.90792345,
    "tofa_ci_low": 0.8037965361979167,
    "tofa_ci_high": 1.02415233,
    "linear_mean": 1.0694688874999998,
    "win_rate": 0.78125,
    "delta": 0.16154543749999997,
}


def test_summary_stats_regression_fat_tree_32():
    rs = run_replicas("fat-tree", n_replicas=32, fast=True, device=CPU)
    s_tofa = rs.summary("tofa", B=1000, seed=0)
    s_lin = rs.summary("linear", B=1000, seed=0)
    cmp = rs.compare(B=1000, seed=0)
    assert s_tofa.mean == pytest.approx(PINNED["tofa_mean"], rel=1e-9)
    assert s_tofa.ci_low == pytest.approx(PINNED["tofa_ci_low"], rel=1e-9)
    assert s_tofa.ci_high == pytest.approx(PINNED["tofa_ci_high"], rel=1e-9)
    assert s_lin.mean == pytest.approx(PINNED["linear_mean"], rel=1e-9)
    assert cmp.win_rate == pytest.approx(PINNED["win_rate"], rel=1e-9)
    assert cmp.delta == pytest.approx(PINNED["delta"], rel=1e-9)


def test_pinned_values_are_the_reference_tests():
    """The pin above and ``chip_smoke.py``'s are the reference test's."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    mods = {}
    for name, path in (("test_replicas", root / "tests" / "test_replicas.py"),
                       ("chip_smoke", root / "chip_smoke.py")):
        spec = importlib.util.spec_from_file_location(name, path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    assert PINNED == mods["test_replicas"].PINNED
    assert mods["chip_smoke"].PINNED_REPLICAS == PINNED


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("preset,seeds", [("fat-tree", [0, 7, 31]),
                                          ("saturated-queue", [2, 5]),
                                          ("paper-fig4-5", [0, 3])])
def test_replicas_equal_reference(preset, seeds):
    """The port's replica engine and the reference's on the same seeds:
    every metric array equal (wall-clock fields excepted)."""
    got = run_replicas(preset, seeds=seeds, fast=True, executor="serial",
                       device=CPU)
    want = R_rep.run_replicas(preset, seeds=seeds, fast=True,
                              executor="serial")
    assert got.seeds == want.seeds and got.policies == want.policies
    assert got.metrics.keys() == want.metrics.keys()
    for pol, metrics in want.metrics.items():
        assert got.metrics[pol].keys() == metrics.keys()
        for k, v in metrics.items():
            if k != "place_time_s":
                assert np.array_equal(got.metrics[pol][k], v), (pol, k)


@pytest.mark.parametrize("executor,device,workers,n,want", [
    ("auto", "cuda", 8, 32, "serial"),
    ("auto", "cuda:0", 8, 1000, "serial"),
    ("auto", "cpu", 8, 32, "process"),
    ("auto", "cpu", 8, 7, "serial"),
    ("auto", "cpu", 1, 32, "serial"),
    ("process", "cuda", 8, 2, "process"),
    ("process", "cpu", 1, 32, "serial"),
    ("serial", "cpu", 8, 32, "serial"),
])
def test_choose_executor(executor, device, workers, n, want):
    """``executor="auto"`` never pools on a CUDA device; on the CPU it
    pools as the reference does.  An explicit ``"process"`` pools on
    either (its workers are spawned, never forked)."""
    assert choose_executor(executor, torch.device(device), workers, n) \
        == want


def test_replicas_target_the_card(monkeypatch):
    """Without ``device`` the replicas' engines target ``cuda``: with no
    GPU ``run_replicas`` and the vectorized path raise up front."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend, "_TORCH", {})
    with pytest.raises(backend.BackendUnavailableError):
        run_replicas("fat-tree", n_replicas=2, fast=True)
    with pytest.raises(backend.BackendUnavailableError):
        run_replicas("paper-fig4-5", n_replicas=2, fast=True)
    with pytest.raises(backend.BackendUnavailableError):
        paper_replica_vector(seed=0, fast=True)
