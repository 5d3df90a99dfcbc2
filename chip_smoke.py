#!/usr/bin/env python3
"""Drive the repro_torch port on one NVIDIA GPU and check what it returns.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit.  The script

1. builds the port's CUDA kernels from the ``.cu`` sources in the checkout
   (one ``nvcc`` per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at full
   shapes, float64 and float32, with integer-valued inputs, requiring exact
   equality, and times both on the card alone (CUDA events around calls
   queued behind a spin kernel) and the kernel wrapper's host time;
3. places real jobs through the port's ``PlacementEngine`` (torch backend
   on ``cuda``, float64) — dense, fault-weighted, dense-guest, implicit
   torus and implicit fat-tree paths — and requires each hop-bytes to equal
   the reference package's NumPy result, and each kernel to have been
   launched on the path that needs it (launch counts are zeroed just
   before each placement and read just after; the three cheap cells are
   placed once more under ``torch.profiler`` for the device's busy time);
4. holds each kernel against its plain version again at the largest shape
   the placements handed it, and reports those times in the summary line;
5. holds the model-stack kernels (``flash_attention``, ``rmsnorm``,
   ``swap_gain``) against their plain versions at the shapes smollm-135m
   gives them, within the reference's kernel-test tolerances (exactly, for
   ``swap_gain`` on integer-valued inputs), and times each beside the one
   PyTorch call that computes the same function, where there is one;
   ``rmsnorm`` and ``swap_gain`` are then driven once through their entry
   points;
6. runs smollm-135m at full width and depth (30 layers, float32,
   NumPy-seeded weights) on ``cuda``: a 2048-token forward through the
   flash kernel, held to the same forward through the plain version and to
   the reference package's logits (``EXPECTED_FORWARD``); 8 decode steps
   from empty caches, held to the forward (forward and decode then run
   once more under ``torch.profiler``); and the serve driver with its
   default arguments;
7. holds the ``ssd_scan`` kernel against the exact recurrence and the
   chunked plain version at the reference's kernel-test shapes, the
   reduced mamba2's and mamba2-2.7b's own (chunk 64 and 128), float32 and
   bfloat16, and runs mamba2-2.7b at full width: two layers on
   NumPy-seeded weights held to the reference package's logits
   (``EXPECTED_MAMBA2``); all 64 layers on a 2 x 2048-token forward, held
   to its plain-version forward; 8 decode steps from empty caches held to
   that forward; and the serve driver;
8. runs the paper's Section 5.2 experiment through the port's scenario
   presets with every placement on ``cuda`` (the ``paper`` phase):
   ``paper-fig4-5`` at the paper's protocol for 85-rank NPB-DT (10
   batches x 100 instances, 16 faulty candidates, p_f 0.02) and for
   64-rank LAMMPS (3 batches), each policy's completion times held bit for
   bit to the reference package's (``EXPECTED_PAPER``), one more NPB-DT
   batch under ``torch.profiler``; the scheduler's elastic re-placement of
   a LAMMPS job whose node dies, held to ``EXPECTED_ELASTIC``; and the
   nine other presets at ``fast=True``, each held to the same preset on
   the CPU.

Steps 5 to 7 run between steps 2 and 3; ``ssd_scan`` is checked with the
other model kernels in step 5.  Each phase prints one JSON
line.  Then come the kernel summary line, the card's name and power
limit, and, only when every phase passed, the final
``{"ok": true, ...}`` line.  Any failure exits non-zero without it.  The
compiler's resource report and the profiler tables go to ``chiprun_out/``.

The script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bandwidth, the non-tensor-core float32 / float64 rates, and the dense
# bfloat16 tensor-core rate.  float32 work is bound by the non-tensor rate
# because TF32 is off (main() turns it off for matmul and cuDNN).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}

# Reference hop-bytes.  The first two are committed in
# benchmarks/BENCH_mapping.json (trajectory point "pr9-sharded-refine").
# The others were computed with the reference package's NumPy engine
# (float64, policy seeded with np.random.default_rng(0)):
#   PYTHONPATH=src python -c "import numpy as np; from repro.core.engine \
#     import PlacementEngine, PlacementRequest; ...; print(PlacementEngine(\
#     backend='numpy').place(req, policy=..., rng=np.random.default_rng(0))\
#     .hop_bytes)"
# on the same request each phase below builds.
EXPECTED = {
    "place/torus-16x16x16/npb_dt-1024/healthy": 133004800000.0,
    "place/torus-16x16x16/npb_dt-1024/healthy/greedy": 150976000000.0,
    "place/fattree-k16/npb_dt-256/faulty32": 30182400000.0,
    "place/torus-16x16x16/alltoall-1024/healthy": 471755468750.0,
    "place/torus-32x32x16/npb_dt-1024/implicit": 149875200000.0,
    "place/fattree-k32/npb_dt-1024/faulty64": 128102400000.0,
}

# The paper's Section 5.2 experiment (paper phase): run_preset(
# "paper-fig4-5") at the paper's protocol (8x8x8 torus, 10 batches x 100
# instances, 16 faulty candidates per batch, p_f 0.02, seed 0) for 85-rank
# NPB-DT, and for 64-rank LAMMPS cut to 3 batches.  Each policy's batch
# completion times (simulated seconds), aborted attempts and event count,
# as the reference package's preset returns them on its NumPy engine; the
# test tests/test_torch_paper_expected.py recomputes them:
#   PYTHONPATH=src python -m pytest -q tests/test_torch_paper_expected.py
EXPECTED_PAPER = {
    "npb_dt-85": {
        "linear": {"batch_completions": [
            22.891540000000017, 21.67606000000001, 22.081220000000013,
            23.29670000000002, 21.270900000000008, 22.486380000000015,
            20.258000000000003, 21.47348000000001, 21.67606000000001,
            20.460580000000004], "aborted_attempts": 74, "n_events": 2148},
        "tofa": {"batch_completions": [
            15.642000000000024, 14.109999999999982, 14.10599999999999,
            14.104000000000017, 16.154000000000035, 14.62000000000002,
            14.62000000000002, 14.10599999999999, 15.130000000000042,
            13.593999999999983], "aborted_attempts": 0, "n_events": 2000},
    },
    "lammps-64": {
        "linear": {"batch_completions": [
            69.37440799999993, 63.74945599999994, 66.87442933333327],
            "aborted_attempts": 20, "n_events": 640},
        "tofa": {"batch_completions": [
            57.085866666666625, 56.85946666666676, 54.8870666666666],
            "aborted_attempts": 0, "n_events": 600},
    },
}
# the paper's TOFA improvement over Slurm's default placement
PAPER_IMPROVEMENT = {"npb_dt-85": 0.31, "lammps-64": 0.189}
# Elastic re-placement (examples/fault_tolerant_batch.py step 3) on a
# fresh scheduler: 8x8x8 torus, one all-replied heartbeat round,
# lammps_like(64) submitted under tofa, then the node under rank 10 dies.
# The reference package's scheduler on its NumPy engine gives this victim,
# hop-bytes before, and re-placement (recomputed by the same test).
EXPECTED_ELASTIC = {
    "victim": 10, "hop_bytes_before": 22338560000.0,
    "hop_bytes": 22645760000.0, "provenance": "replace-incremental",
    "placement": [
        15, 7, 56, 0, 9, 3, 2, 1, 17, 11, 19, 18, 16, 8, 49, 25, 71, 113,
        57, 121, 67, 123, 58, 122, 83, 75, 82, 146, 80, 73, 89, 81, 64,
        120, 185, 65, 131, 130, 186, 129, 139, 74, 66, 138, 144, 136, 137,
        145, 72, 79, 184, 128, 201, 202, 194, 193, 457, 458, 450, 449, 465,
        456, 505, 448],
}

# The full-width smollm-135m forward (model phase) is held to the
# reference package at these positions of each of its two rows.
HELD_POSITIONS = (0, 1023, 2047)
# forward_summary of the reference package's forward (CPU, float32) on the
# same weights, interop.seeded_params(smollm-135m, seed=0), and tokens,
# SyntheticDataset(49152, 2048, 2, seed=0).batch(0), that the model phase
# runs: row 0 at HELD_POSITIONS, then row 1.  The test
# tests/test_torch_models.py::test_expected_forward_is_the_reference
# recomputes them with the reference package:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_models.py -k expected_forward
EXPECTED_FORWARD = [
    [48467, -270.35507481644163, 0.04476463794708252],
    [41252, 104.98106756992638, 0.0692596435546875],
    [44141, 135.47028165729716, 0.2727811336517334],
    [34651, -61.52785515564028, 0.10175049304962158],
    [13620, -24.220059016370215, 0.060172438621520996],
    [43510, -93.21593950502574, 0.29175543785095215],
]


def forward_summary(held) -> list:
    """[argmax id, float64 sum, top-2 gap] of each row's logits at each of
    ``HELD_POSITIONS``; ``held`` is ``logits[:, HELD_POSITIONS]``, a
    (B, len(HELD_POSITIONS), V) NumPy array."""
    import numpy as np
    out = []
    for row in held:
        for v in np.asarray(row, dtype=np.float64):
            top2 = np.sort(v)[-2:]
            out.append([int(np.argmax(v)), float(v.sum()),
                        float(top2[1] - top2[0])])
    return out


def forward_agrees(summary, expected=EXPECTED_FORWARD) -> bool:
    """Sums within rtol 1e-4 of the expected ones, and argmax ids equal
    wherever the expected top-2 gap exceeds 1e-3."""
    return len(summary) == len(expected) and all(
        abs(s[1] - e[1]) <= 1e-4 * abs(e[1])
        and (s[0] == e[0] or e[2] <= 1e-3)
        for s, e in zip(summary, expected))


# The cut-depth mamba2-2.7b forward (two layers, full width, B 2 x 256
# tokens) is held to the reference package at these positions.
MAMBA2_HELD_POSITIONS = (0, 127, 255)
# forward_summary of the reference package's forward (CPU, float32) on
# interop.seeded_params(mamba2-2.7b with n_layers=2, seed=0) and
# SyntheticDataset(50280, 256, 2, seed=0).batch(0): row 0 at
# MAMBA2_HELD_POSITIONS, then row 1.  Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_ssm.py -k expected_mamba2
EXPECTED_MAMBA2 = [
    [25942, 30.699237526394427, 0.7524933815002441],
    [14439, 38.93713191058487, 0.30605459213256836],
    [5842, -225.65918770618737, 0.37107372283935547],
    [12249, 175.2925356309861, 0.2604396343231201],
    [21853, 405.7033743020147, 0.2919578552246094],
    [11623, 198.10172006301582, 0.5906195640563965],
]


KERNELS = {
    "swap_select": dict(
        source="src/repro_torch/kernels/swap_gain/swap_select.cu",
        replaces="src/repro/kernels/swap_gain/kernel.py:126"),
    "torus_hop": dict(
        source="src/repro_torch/kernels/hop_dist/hop_dist.cu",
        replaces="src/repro/kernels/hop_dist/kernel.py:35"),
    "fattree_hop": dict(
        source="src/repro_torch/kernels/hop_dist/hop_dist.cu",
        replaces="src/repro/kernels/hop_dist/kernel.py:85"),
    "swap_gain": dict(
        source="src/repro_torch/kernels/swap_gain/swap_select.cu",
        replaces="src/repro/kernels/swap_gain/kernel.py:43"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/flash_attention/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81"),
    "rmsnorm": dict(
        source="src/repro_torch/kernels/rmsnorm/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:24"),
    "ssd_scan": dict(
        source="src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:75"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(logs: dict) -> list:
    """Registers and spill bytes of every kernel instance in ptxas's
    report (``nvcc -Xptxas -v``), by source; names demangled with
    ``c++filt`` where it is installed."""
    rows, cur = [], None
    for source, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"source": source, "kernel": m.group(1)}
                rows.append(cur)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur is not None:
                cur["spill_store_bytes"] = int(m.group(1))
                cur["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
    try:
        out = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if len(out) == len(rows):
        for r, name in zip(rows, out):
            name = name.replace("(anonymous namespace)::", "")
            r["kernel"] = name.split("(")[0].removeprefix("void ")
    return rows


def cuda_ms(fn, reps: int = 20, trials: int = 5, warmup: int = 3,
            strict: bool = True) -> tuple[float, float, bool]:
    """(device ms, host ms, queued ahead) per call of ``fn()``, medians of
    ``trials``.

    Device: CUDA events around ``reps`` back-to-back calls, enqueued
    behind a spin kernel (``torch.cuda._sleep``) that keeps the card busy
    until the host has queued all of them, so the events hold only the
    card's work, not the host's launch cost between calls.  With
    ``strict``, a trial whose first event the card reached before the
    host finished queueing is repeated with a spin twice as long; without
    it (a function that waits for the card itself, as the plain versions
    may) the trial is kept and the third value says whether every kept
    trial stayed ahead.  Host: wall time of queueing the ``reps`` calls,
    per call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, host, spin, all_ahead = [], [], 1 << 22, True
    while len(dev) < trials:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued = time.perf_counter() - t0
        ahead = not a.query()
        b.record()
        b.synchronize()
        if strict and not ahead:
            if spin >= 1 << 30:
                raise RuntimeError("the card caught up with the host "
                                   "however long the spin ahead of it")
            spin *= 2
            continue
        all_ahead &= ahead
        dev.append(a.elapsed_time(b) / reps)
        host.append(queued / reps * 1e3)
    return statistics.median(dev), statistics.median(host), all_ahead


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def _tdtype(name: str):
    import torch
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[name]


def check_swap_select(dev, dt: str, B: int, n: int, tag: str) -> dict:
    """swap_select against its plain version at (B, n, n): several mover
    sets, a padded n_valid with padding movers, and an all-reject case."""
    import numpy as np
    import torch
    from repro_torch.kernels.swap_gain.ops import swap_select
    from repro_torch.kernels.swap_gain.ref import swap_select_ref

    rng = np.random.default_rng(0)
    tdt, size = _tdtype(dt), (8 if dt == "float64" else 4)
    A = rng.integers(0, 7, (B, n, n))
    M = torch.tensor(A + A.transpose(0, 2, 1), dtype=tdt, device=dev)
    S = rng.integers(0, 5, (n, n)) * (rng.random((n, n)) < 0.3)
    G = torch.tensor(S + S.T, dtype=tdt, device=dev)
    contrib = (G[None] * M).sum(-1)
    nv_pad = max(1, n * 125 // 128)             # 1000 of 1024 live
    cases = [(M, G, contrib, torch.tensor(rng.integers(0, n, B)), n),
             (M, G, contrib, torch.tensor(rng.integers(0, n, B)), nv_pad)]
    one = torch.ones((n, n), dtype=tdt, device=dev) - torch.eye(
        n, dtype=tdt, device=dev)
    Mo = one.expand(B, n, n).contiguous()
    cases.append((Mo, one, (one[None] * Mo).sum(-1),
                  torch.arange(B) % n, n))
    exact, err = True, 0.0
    for k, (Mx, Gx, cx, i, nv) in enumerate(cases):
        i = i.to(dev)
        g_k, j_k = swap_select(Mx, Gx, cx, i, nv, impl="kernel")
        g_r, j_r = swap_select_ref(Mx, Gx, cx, i, nv)
        torch.cuda.synchronize()
        exact &= bool(torch.equal(j_k, j_r)) and bool(torch.equal(g_k, g_r))
        if k == 2:                               # every mover rejected
            exact &= bool(torch.equal(j_k, i))
        err = max(err, float((g_k - g_r).abs().max()))
    i = cases[0][3].to(dev)
    # n_valid as a device tensor, as the refine loop hands it over: an
    # int would cost a blocking host-to-device copy in every call
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    ms, host, _ = cuda_ms(lambda: swap_select(M, G, contrib, i, nv,
                                              impl="kernel"))
    plain, _, plain_ahead = cuda_ms(
        lambda: swap_select_ref(M, G, contrib, i, n), strict=False)
    nbytes = (B * n * n + n * n + B * n) * size + B * (8 + size + 8)
    bnd, by = bound_ms(nbytes, 4.0 * B * n * n, dt)
    rec = dict(max_abs_err=err, ms=ms, host_ms=host, plain_ms=plain,
               plain_queued_ahead=plain_ahead, bound_ms=bnd, bound_by=by)
    emit({"phase": tag, "kernel": "swap_select", "dtype": dt,
          "shape": [B, n, n], "exact": exact, **rec})
    if not exact:
        raise AssertionError(f"swap_select disagrees at {(B, n, dt)}")
    return rec


def check_hop(dev, kernel: str, dt: str, B: int, m: int, k: int,
              tag: str, dims=(32, 32, 16), arity: int = 32) -> dict:
    """torus_hop / fattree_hop against the plain version at (B, m, k)."""
    import numpy as np
    import torch
    from repro_torch.kernels.hop_dist import ops as hop_ops
    from repro_torch.kernels.hop_dist.ref import (fattree_hop_pairs_ref,
                                                  torus_hop_pairs_ref)

    rng = np.random.default_rng(1)
    tdt, size = _tdtype(dt), (8 if dt == "float64" else 4)
    if kernel == "torus_hop":
        ext = dims
        run = lambda a, b: hop_ops.torus_hop(a, b, dims, impl="kernel")
        ref = lambda a, b: torus_hop_pairs_ref(a, b, dims)
        ops_per = 5.0 * len(dims)
    else:
        ext = (arity, arity // 2, arity // 2)
        run = lambda a, b: hop_ops.fattree_hop(a, b, impl="kernel")
        ref = fattree_hop_pairs_ref
        ops_per = 9.0
    cu = torch.tensor(np.stack([rng.integers(0, e, (B, m)) for e in ext], -1),
                      dtype=tdt, device=dev)
    cv = torch.tensor(np.stack([rng.integers(0, e, (B, k)) for e in ext], -1),
                      dtype=tdt, device=dev)
    out_k, out_r = run(cu, cv), ref(cu, cv)
    torch.cuda.synchronize()
    exact = bool(torch.equal(out_k, out_r))
    err = float((out_k - out_r).abs().max())
    del out_k, out_r
    ms, host, _ = cuda_ms(lambda: run(cu, cv))
    plain, _, plain_ahead = cuda_ms(lambda: ref(cu, cv), strict=False)
    nbytes = (B * (m + k) * len(ext) + B * m * k) * size
    bnd, by = bound_ms(nbytes, ops_per * B * m * k, dt)
    rec = dict(max_abs_err=err, ms=ms, host_ms=host, plain_ms=plain,
               plain_queued_ahead=plain_ahead, bound_ms=bnd, bound_by=by)
    emit({"phase": tag, "kernel": kernel, "dtype": dt, "shape": [B, m, k],
          "extents": list(ext), "exact": exact, **rec})
    if not exact:
        raise AssertionError(f"{kernel} disagrees at {(B, m, k, dt)}")
    return rec


def kernel_phase(dev) -> None:
    """Each kernel against its plain version at the full shapes TOFA's
    16-candidate stack gives it, float64 and float32."""
    import torch
    for dt in ("float64", "float32"):
        check_swap_select(dev, dt, 16, 1024, "kernels")
        check_hop(dev, "torus_hop", dt, 16, 1024, 1024, "kernels")
        check_hop(dev, "fattree_hop", dt, 16, 1024, 1024, "kernels")
        torch.cuda.empty_cache()


def main_shape_phase(dev) -> dict:
    """Each kernel at the largest shape the main path handed it (float64,
    the main path's dtype); these numbers go into the summary line."""
    recs = {}
    for name in ("swap_select", "torus_hop", "fattree_hop"):
        shape = MAIN_PATH_SHAPES[name]
        if shape is None:
            continue
        if name == "swap_select":
            recs[name] = check_swap_select(dev, "float64", shape[0],
                                           shape[1], "kernels/main-shape")
        else:
            recs[name] = check_hop(dev, name, "float64", *shape,
                                   "kernels/main-shape")
    return recs


# --------------------------------------------------------------- placement
def _faults(n_nodes: int, count: int):
    import numpy as np
    p_f = np.zeros(n_nodes)
    bad = np.random.default_rng(7).choice(n_nodes, count, replace=False)
    p_f[bad] = 0.02
    return p_f


def place_phase(name: str, request, policies=("tofa",),
                need: tuple = (), profile: bool = False,
                warm: bool = True) -> None:
    """Cold then (with ``warm``) warm placement per policy on a fresh
    engine; checks the hop-bytes against the reference, that a warm
    placement repeats the cold one, and that ``need`` kernels ran.  With
    ``profile``, one more placement runs under ``torch.profiler`` to read
    the device's busy time (the per-op table goes to ``chiprun_out/``)."""
    import numpy as np
    import torch
    from repro_torch.core import mapping_torch
    from repro_torch.core.engine import PlacementEngine
    from repro_torch.kernels import LAUNCHES, SHAPES, reset_launches

    engine = PlacementEngine()                      # torch, cuda, float64
    for pol in policies:
        key = name if pol == "tofa" else f"{name}/{pol}"
        reset_launches()
        mapping_torch.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plan = engine.place(request, policy=pol, rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        layer = {k: dict(v) for k, v in mapping_torch.STATS.items()
                 if v["calls"]}
        for k, v in launches.items():
            MAIN_PATH_LAUNCHES[k] += v
            keep_shape(k, SHAPES[k])
        p = np.asarray(plan.placement)
        warm_s, repeats = None, True
        if warm:
            t0 = time.perf_counter()
            warm_plan = engine.place(request, policy=pol,
                                     rng=np.random.default_rng(0))
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            repeats = np.array_equal(p, warm_plan.placement)
        valid = (p.dtype.kind == "i" and len(set(p.tolist())) == len(p)
                 and bool(np.isin(p, request.available_ids).all()))
        ok = (valid and repeats and plan.hop_bytes == EXPECTED[key]
              and all(launches[k] > 0 for k in need))
        row = {"phase": key, "policy": pol, "n_procs": request.n_procs,
               "n_nodes": request.n_nodes, "cold_s": cold, "warm_s": warm_s,
               "hop_bytes": plan.hop_bytes, "expected": EXPECTED[key],
               "launches": launches, "needs": list(need),
               "cold_layer": layer,
               "transfers": engine.backend.stats["transfers"],
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "ok": ok}
        if profile and pol == "tofa":
            row.update(profiled(lambda: engine.place(
                request, policy="tofa", rng=np.random.default_rng(0)), key))
        emit(row)
        if not ok:
            raise AssertionError(f"{key} failed its check")


def profiled(run, key: str) -> dict:
    """``run()`` once more, warm, under torch.profiler: wall time, summed
    device time of every kernel and copy, and the device idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_events = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e6
    OUT_DIR.mkdir(exist_ok=True)
    fname = OUT_DIR / ("profile_" + key.replace("/", "_") + ".txt")
    fname.write_text(
        ka.table(sort_by="self_device_time_total", row_limit=25)
        + "\n" + ka.table(sort_by="self_cpu_time_total", row_limit=25))
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_ops": sum(e.count for e in dev_events)}


# launches of each kernel on the path that needs it (the placement phases,
# the model phases, the rmsnorm and swap_gain entry-point phases), and the
# largest shape each was launched at there (see repro_torch.kernels.SHAPES)
MAIN_PATH_LAUNCHES = {name: 0 for name in KERNELS}
MAIN_PATH_SHAPES = {name: None for name in KERNELS}


def keep_shape(name: str, shape) -> None:
    old = MAIN_PATH_SHAPES[name]
    if shape is not None and (old is None
                              or math.prod(shape) > math.prod(old)):
        MAIN_PATH_SHAPES[name] = shape


def placement_phases() -> None:
    from repro_torch.core.engine import PlacementRequest
    from repro_torch.core.fattree import FatTreeTopology
    from repro_torch.core.topology import TorusTopology
    from repro_torch.workloads.patterns import alltoall_heavy, npb_dt_like

    npb1024 = npb_dt_like(1024, seed=3).comm
    t16 = TorusTopology((16, 16, 16))
    yield lambda: place_phase(
        "place/torus-16x16x16/npb_dt-1024/healthy",
        PlacementRequest(comm=npb1024, topology=t16),
        policies=("tofa", "greedy"), profile=True)
    ft16 = FatTreeTopology(16)
    yield lambda: place_phase(
        "place/fattree-k16/npb_dt-256/faulty32",
        PlacementRequest(comm=npb_dt_like(256, seed=3).comm, topology=ft16,
                         p_f=_faults(ft16.n_nodes, 32)), profile=True)
    yield lambda: place_phase(
        "place/torus-16x16x16/alltoall-1024/healthy",
        PlacementRequest(comm=alltoall_heavy(1024).comm, topology=t16),
        need=("swap_select",), profile=True)
    yield lambda: place_phase(
        "place/torus-32x32x16/npb_dt-1024/implicit",
        PlacementRequest(comm=npb1024, topology=TorusTopology((32, 32, 16))),
        need=("torus_hop",), warm=False)
    ft32 = FatTreeTopology(32)
    yield lambda: place_phase(
        "place/fattree-k32/npb_dt-1024/faulty64",
        PlacementRequest(comm=npb1024, topology=ft32,
                         p_f=_faults(ft32.n_nodes, 64)),
        need=("fattree_hop",), warm=False)


# -------------------------------------------------- the paper's experiment
PAPER_FIELDS = ("batch_completions", "aborted_attempts", "n_events")


def _without_wall_clock(x):
    """A preset's result without its wall-clock ``place_time_s`` fields."""
    if isinstance(x, dict):
        return {k: _without_wall_clock(v) for k, v in x.items()
                if k != "place_time_s"}
    if isinstance(x, (list, tuple)):
        return [_without_wall_clock(v) for v in x]
    return x


def host_eq1_seconds(run) -> tuple:
    """``run()``'s result, and the seconds and calls it spent in the
    host's Eq. 1 weight derivation: ``TorusTopology.weight_matrix`` (a
    full derivation) and ``weight_matrix_update`` (the row-wise refresh
    after a health change), timed by wrapping both for the call."""
    from repro_torch.core.topology import TorusTopology

    spent = {"weight_matrix": 0.0, "weight_matrix_update": 0.0}
    calls = dict.fromkeys(spent, 0)
    orig = {name: getattr(TorusTopology, name) for name in spent}

    def timed(name):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig[name](*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
        return wrapper

    for name in spent:
        setattr(TorusTopology, name, timed(name))
    try:
        out = run()
    finally:
        for name, fn in orig.items():
            setattr(TorusTopology, name, fn)
    return out, {"s": spent, "calls": calls}


def paper_cell(cell: str, device, **kw) -> None:
    """``paper-fig4-5`` for linear and tofa on ``device``, held bit for bit
    to ``EXPECTED_PAPER[cell]``; prints mean completions, the TOFA
    improvement beside the paper's, the mapper's seconds per policy, and
    the launches of each kernel (the preset's sparse guests on a dense
    512-node torus reach none), and the seconds and share of the cell's
    wall time spent in the host's Eq. 1 weight derivation."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sim.scenarios import run_preset

    reset_launches()
    t0 = time.perf_counter()
    out, eq1 = host_eq1_seconds(lambda: run_preset(
        "paper-fig4-5", policies=("linear", "tofa"), seed=0, device=device,
        **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = out["policies"]
    got = {pol: {k: rows[pol][k] for k in PAPER_FIELDS} for pol in rows}
    imp = 1.0 - rows["tofa"]["mean_completion"] \
        / rows["linear"]["mean_completion"]
    ok = got == EXPECTED_PAPER[cell]
    emit({"phase": f"paper/{cell}", "params": out["params"],
          "mean_completion": {p: r["mean_completion"]
                              for p, r in rows.items()},
          "aborted_attempts": {p: r["aborted_attempts"]
                               for p, r in rows.items()},
          "tofa_improvement": imp, "paper_improvement": PAPER_IMPROVEMENT[cell],
          "place_time_s": {p: r["place_time_s"] for p, r in rows.items()},
          "host_eq1": eq1, "host_eq1_share": sum(eq1["s"].values()) / wall,
          "wall_s": wall, "launches": dict(LAUNCHES), "ok": ok})
    if not ok:
        raise AssertionError(f"paper/{cell} differs from EXPECTED_PAPER")


def elastic_phase(device) -> None:
    """A scheduler on ``device`` places lammps_like(64) under tofa; the
    node under rank 10 dies and ``engine.replace`` re-places the job.
    Held to ``EXPECTED_ELASTIC``; the victim must be gone."""
    import numpy as np
    import torch
    from repro_torch.cluster.scheduler import Job, Scheduler
    from repro_torch.core.topology import TorusTopology
    from repro_torch.workloads.patterns import lammps_like

    t0 = time.perf_counter()
    sch = Scheduler(TorusTopology((8, 8, 8)), device=device)
    sch.heartbeat_round(np.ones(512, dtype=bool))
    rec = sch.submit(Job(lammps_like(64), distribution="tofa"))
    victim = int(rec.placement.placement[10])
    before = rec.placement.hop_bytes
    placed = rec.placement.placement.copy()
    affected = sch.handle_node_failure([victim])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plan = rec.placement
    exp = EXPECTED_ELASTIC
    ok = (victim == exp["victim"] and before == exp["hop_bytes_before"]
          and len(affected) == 1 and rec.restarts == 1
          and victim not in set(plan.placement.tolist())
          and plan.placement.tolist() == exp["placement"]
          and plan.hop_bytes == exp["hop_bytes"]
          and plan.provenance == exp["provenance"])
    emit({"phase": "paper/elastic-replace", "victim": victim,
          "hop_bytes_before": before, "hop_bytes": plan.hop_bytes,
          "provenance": plan.provenance, "restarts": rec.restarts,
          "moved": int((plan.placement != placed).sum()),
          "place_time_s": sch.place_time_s, "wall_s": wall, "ok": ok})
    if not ok:
        raise AssertionError("paper/elastic-replace differs from "
                             "EXPECTED_ELASTIC")


def presets_phase(device) -> None:
    """The nine other presets at ``fast=True`` on ``device``, each held
    bit for bit (wall-clock fields excepted) to the same preset run by
    the port on the CPU."""
    import torch
    from repro_torch.sim.scenarios import SCENARIOS, run_preset

    bad = []
    for name in SCENARIOS:
        if name == "paper-fig4-5":
            continue
        t0 = time.perf_counter()
        got = run_preset(name, fast=True, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = run_preset(name, fast=True, device="cpu")
        cpu_wall = time.perf_counter() - t0
        ok = _without_wall_clock(got) == _without_wall_clock(want)
        emit({"phase": f"paper/preset/{name}", "wall_s": wall,
              "cpu_wall_s": cpu_wall, "ok": ok})
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"presets differ between the card and the "
                             f"CPU: {bad}")


def paper_phase(device) -> None:
    """The paper's Section 5.2 experiment on the port's engine on
    ``device``: NPB-DT-85 at the full protocol, LAMMPS-64 at 3 batches,
    one more NPB-DT batch under ``torch.profiler``, the elastic
    re-placement, and the nine other presets at ``fast=True``."""
    from repro_torch.sim.scenarios import run_preset
    from repro_torch.workloads.patterns import lammps_like

    t0 = time.perf_counter()
    paper_cell("npb_dt-85", device)
    paper_cell("lammps-64", device, n_batches=3,
               wl_factory=lambda: lammps_like(64))
    emit({"phase": "paper/npb_dt-85/profiled-batch", **profiled(
        lambda: run_preset("paper-fig4-5", n_batches=1, device=device),
        "paper_npb_dt-85_batch0")})
    elastic_phase(device)
    presets_phase(device)
    emit({"phase": "paper/done", "s": time.perf_counter() - t0})


# ------------------------------------------------------ model-stack kernels
# the reference's kernel-test tolerances (tests/test_kernels.py TOL)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh) of smollm-135m's 2048-token
# forward, which the model phase hands the flash kernel
FLASH_MAIN = (2, 9, 3, 2048, 2048, 64)
RMSNORM_MAIN = (2 * 2048, 576)           # (rows, D): smollm's activations
SWAP_GAIN_N = 1024


def _record(max_abs_err, ms, host, plain, plain_ahead, library, nbytes,
            ops, dt) -> dict:
    bnd, by = bound_ms(nbytes, ops, dt)
    return dict(max_abs_err=max_abs_err, ms=ms, host_ms=host, plain_ms=plain,
                plain_queued_ahead=plain_ahead, library_ms=library,
                bound_ms=bnd, bound_by=by)


def check_flash(dev, dt: str, shape: tuple, tag: str) -> dict:
    """flash_attention (causal) against its plain version at ``shape``,
    timed beside F.scaled_dot_product_attention on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, H, Hkv, Sq, Sk, Dh = shape
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(_tdtype(dt))
               for s in ((B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh)))
    got = flash_attention(q, k, v, causal=True, impl="kernel")
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), atol=TOL[dt],
                             rtol=TOL[dt]))
    del got, want
    ms, host, _ = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                                  impl="kernel"))
    plain, _, plain_ahead = cuda_ms(
        lambda: flash_attention_ref(q, k, v, causal=True), strict=False)
    library, _, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    size = q.element_size()
    # the (query, key) pairs the causal mask leaves visible, each a Dh-long
    # dot product for the score and a Dh-long update of the output
    pairs = sum(max(0, min(Sk, i + 1 + Sk - Sq)) for i in range(Sq))
    nbytes = (2 * B * H * Sq * Dh + 2 * B * Hkv * Sk * Dh) * size
    rec = _record(err, ms, host, plain, plain_ahead, library, nbytes,
                  4.0 * Dh * pairs * B * H, dt)
    rec["ms_over_library"] = ms / library
    emit({"phase": tag, "kernel": "flash_attention", "dtype": dt,
          "shape": list(shape), "causal": True, "tol": TOL[dt], "ok": ok,
          **rec})
    if not ok:
        raise AssertionError(f"flash_attention disagrees at {shape} {dt}")
    return rec


def check_rmsnorm(dev, dt: str, rows: int, D: int, tag: str) -> dict:
    """rmsnorm against the model's plain rmsnorm, timed beside
    F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((rows, D), generator=g, device=dev).to(_tdtype(dt))
    w = (torch.randn(D, generator=g, device=dev) + 1.0).to(_tdtype(dt))
    got, want = rmsnorm(x, w, impl="kernel"), rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), atol=TOL[dt],
                             rtol=TOL[dt]))
    ms, host, _ = cuda_ms(lambda: rmsnorm(x, w, impl="kernel"))
    plain, _, plain_ahead = cuda_ms(lambda: rmsnorm_ref(x, w), strict=False)
    library, _, _ = cuda_ms(lambda: F.rms_norm(x, (D,), w, eps=1e-6))
    size = x.element_size()
    rec = _record(err, ms, host, plain, plain_ahead, library,
                  (2 * rows * D + D) * size, 4.0 * rows * D, dt)
    emit({"phase": tag, "kernel": "rmsnorm", "dtype": dt,
          "shape": [rows, D], "tol": TOL[dt], "ok": ok, **rec})
    if not ok:
        raise AssertionError(f"rmsnorm disagrees at {(rows, D)} {dt}")
    return rec


def check_swap_gain(dev, dt: str, n: int, tag: str) -> dict:
    """swap_gain against its plain version at (n, n), integer-valued
    inputs, several movers: exact equality.  No single PyTorch call
    computes the gains row (library_ms null)."""
    import numpy as np
    import torch
    from repro_torch.kernels.swap_gain.ops import swap_gain
    from repro_torch.kernels.swap_gain.ref import swap_gain_ref

    rng = np.random.default_rng(0)
    tdt = _tdtype(dt)
    A = rng.integers(0, 7, (n, n))
    M = torch.tensor(A + A.T, dtype=tdt, device=dev)
    S = rng.integers(0, 5, (n, n)) * (rng.random((n, n)) < 0.3)
    G = torch.tensor(S + S.T, dtype=tdt, device=dev)
    contrib = (G * M).sum(-1)
    exact, err = True, 0.0
    for i in (0, n // 3, n - 1):
        iv = torch.tensor([i], device=dev)
        got = swap_gain(M, G, contrib, iv, impl="kernel")
        want = swap_gain_ref(M[None], G, contrib[None], iv)[0]
        torch.cuda.synchronize()
        exact &= bool(torch.equal(got, want))
        err = max(err, float((got - want).abs().max()))
    iv = torch.tensor([n // 3], device=dev)
    ms, host, _ = cuda_ms(lambda: swap_gain(M, G, contrib, iv,
                                            impl="kernel"))
    plain, _, plain_ahead = cuda_ms(
        lambda: swap_gain_ref(M[None], G, contrib[None], iv), strict=False)
    size = M.element_size()
    rec = _record(err, ms, host, plain, plain_ahead, None,
                  (2 * n * n + 2 * n) * size + 8, 4.0 * n * n, dt)
    emit({"phase": tag, "kernel": "swap_gain", "dtype": dt, "shape": [n, n],
          "exact": exact, **rec})
    if not exact:
        raise AssertionError(f"swap_gain disagrees at n={n} {dt}")
    return rec


# the reference's SSD kernel-test tolerances (tests/test_kernels.py)
SSD_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
# (B, H, G, S, P, N, chunk): the reference's three kernel-test shapes, the
# reduced mamba2's, and mamba2-2.7b's B 2 x 2048 prefill (the main path's,
# chunk 64) also at the entry point's default chunk of 128
SSD_SHAPES = [(1, 2, 1, 64, 16, 16, 16), (2, 4, 2, 128, 32, 32, 32),
              (1, 8, 1, 96, 64, 128, 32), (2, 8, 1, 64, 16, 16, 8)]
SSD_MAIN = (2, 80, 1, 2048, 64, 128, 64)
SSD_MAIN_128 = SSD_MAIN[:6] + (128,)


def ssd_ops(B, H, G, S, P, N) -> float:
    """The least operations of the SSD scan at this shape.  The chunked
    form at a tile of Q rows does, per (b, group, tile), the lower
    triangle of C B^T (the heads of a group share it, N each) and, per
    (b, h, tile), its product with xdt (P each), the carry-in product and
    the state update (Q P N each) and the state's decay (P N); two
    operations per multiply-add.  The result does not depend on the tile,
    so the least count over the tiles 1 (the one-token recurrence) to 64
    (the kernel's) that divide S is taken."""
    def at(Q):
        n, tri = S // Q, Q * (Q + 1) // 2
        return 2.0 * B * G * n * tri * N \
            + B * H * n * (2.0 * tri * P + 4 * Q * P * N + P * N)
    return min(at(Q) for Q in (1, 2, 4, 8, 16, 32, 64) if S % Q == 0)


def check_ssd(dev, dt: str, shape: tuple, tag: str, timed: bool) -> dict:
    """ssd_scan against the exact recurrence (ssd_scan_ref) in both types
    and against the chunked algorithm (``impl="ref"``) in float32, on the
    reference's kernel-test distribution; with ``timed``, the kernel, both
    plain versions and the bound.  No PyTorch call computes the SSD scan
    (library_ms null)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ops import (ssd_scan_kernel,
                                                  workspace_bytes)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    B, H, G, S, P, N, chunk = shape
    g = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)
    tdt = _tdtype(dt)
    xdt = (rand(B, H, S, P) * 0.5).to(tdt)
    dA = (-F.softplus(rand(B, H, S)) * 0.5).to(tdt)
    Bm, Cm = ((rand(B, G, S, N) * 0.5).to(tdt) for _ in range(2))
    run = lambda: ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk,
                                  impl="kernel")
    chunked = lambda: ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk,
                                      impl="ref")
    exact = lambda: ssd_scan_ref(xdt, dA, Bm, Cm, chunk)
    y, st = run()
    wants = {"exact": exact()}
    if dt == "float32":
        wants["chunked"] = chunked()
    torch.cuda.synchronize()
    tol, errs, ok = SSD_TOL[dt], {}, True
    for name, (y_r, st_r) in wants.items():
        errs[name] = max(float((y.float() - y_r.float()).abs().max()),
                         float((st - st_r).abs().max()))
        ok &= bool(torch.allclose(y.float(), y_r.float(), atol=tol, rtol=tol)
                   and torch.allclose(st, st_r, atol=tol, rtol=tol))
    del y, st, wants
    rec = {"max_abs_err": max(errs.values()),
           "workspace_bytes": workspace_bytes(B, H, S, P, N, chunk)}
    if timed:
        ms, host, _ = cuda_ms(run)
        plain, _, plain_ahead = cuda_ms(chunked, strict=False)
        exact_ms, _, _ = cuda_ms(exact, reps=1, trials=3, warmup=1,
                                 strict=False)
        size = xdt.element_size()
        nbytes = (2 * B * H * S * P + 2 * B * G * S * N) * size \
            + B * H * S * dA.element_size() + B * H * P * N * 4
        rec.update(_record(rec["max_abs_err"], ms, host, plain, plain_ahead,
                           None, nbytes, ssd_ops(B, H, G, S, P, N), dt))
        rec["exact_ms"] = exact_ms
    emit({"phase": tag, "kernel": "ssd_scan", "dtype": dt,
          "shape": list(shape), "tol": tol, "max_abs_err_vs": errs,
          "ok": ok, **rec})
    if not ok:
        raise AssertionError(f"ssd_scan disagrees at {shape} {dt}")
    return rec


def model_kernel_phase(dev) -> dict:
    """The model-stack kernels against their plain versions; the records
    at the main path's shape and dtype go into the summary line."""
    import torch
    recs = {}
    for dt in ("float32", "bfloat16"):
        rec = check_flash(dev, dt, FLASH_MAIN, "kernels/model")
        if dt == "float32":          # the model phase runs float32
            recs["flash_attention"] = rec
        torch.cuda.empty_cache()
    check_flash(dev, "bfloat16", (1, 16, 16, 1024, 1024, 192),
                "kernels/model")
    for dt in ("float32", "bfloat16"):
        rec = check_rmsnorm(dev, dt, *RMSNORM_MAIN, "kernels/model")
        if dt == "float32":
            recs["rmsnorm"] = rec
    for dt in ("float64", "float32"):
        rec = check_swap_gain(dev, dt, SWAP_GAIN_N, "kernels/model")
        if dt == "float64":          # the refiner's default dtype
            recs["swap_gain"] = rec
    for dt in ("float32", "bfloat16"):
        for shape in SSD_SHAPES:
            check_ssd(dev, dt, shape, "kernels/model", timed=False)
        rec = check_ssd(dev, dt, SSD_MAIN, "kernels/model", timed=True)
        if dt == "float32":          # the mamba2 phases run float32
            recs["ssd_scan"] = rec
        check_ssd(dev, dt, SSD_MAIN_128, "kernels/model", timed=True)
        torch.cuda.empty_cache()
    return recs


def _count_path(names) -> dict:
    """Add this run's launches of ``names`` to the main-path counts."""
    from repro_torch.kernels import LAUNCHES, SHAPES
    for name in names:
        MAIN_PATH_LAUNCHES[name] += LAUNCHES[name]
        keep_shape(name, SHAPES[name])
    return {name: LAUNCHES[name] for name in names}


def entry_point_phase(dev) -> None:
    """rmsnorm and swap_gain driven once each through their entry points
    (``impl="auto"`` on CUDA tensors), launch counts zeroed just before."""
    import torch
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.swap_gain.ops import swap_gain

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(RMSNORM_MAIN, generator=g, device=dev)
    w = torch.ones(RMSNORM_MAIN[1], device=dev)
    M = torch.rand((SWAP_GAIN_N, SWAP_GAIN_N), generator=g, device=dev,
                   dtype=torch.float64)
    M = M + M.T
    contrib = (M * M).sum(-1)
    i = torch.tensor([5], device=dev)
    reset_launches()
    out = rmsnorm(x, w)
    gains = swap_gain(M, M, contrib, i)
    torch.cuda.synchronize()
    launches = _count_path(("rmsnorm", "swap_gain"))
    ok = (bool(torch.isfinite(out).all()) and bool(torch.isfinite(gains)
                                                   .all())
          and all(n == 1 for n in launches.values()))
    emit({"phase": "entry/rmsnorm+swap_gain", "launches": launches,
          "ok": ok})
    if not ok:
        raise AssertionError("an entry point did not launch its kernel")


def run_forward(model, toks, kernel: str, key: str):
    """The forward of ``model`` on ``toks`` cold, warm, once more under
    the profiler, and through the plain versions (``impl="ref"``), held
    within 1e-4 of each other; ``kernel``'s launch counts are zeroed just
    before the cold forward and read just after it.  Returns (logits,
    record)."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches

    with torch.inference_mode():
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits = model(toks)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = _count_path((kernel,))[kernel]
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        model(toks)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        prof = profiled(lambda: model(toks), key)
        total = LAUNCHES[kernel]
        plain = model(toks, impl="ref")
        torch.cuda.synchronize()
    err = float((logits - plain).abs().max())
    plain_ok = bool(torch.allclose(logits, plain, atol=1e-4, rtol=1e-4))
    del plain
    B, S = toks.shape
    n = model.cfg.n_layers
    rec = {"phase": key, "dtype": str(logits.dtype).replace("torch.", ""),
           "batch": B, "seq": S, "layers": n, "cold_s": cold,
           "warm_s": warm, "prefill_tok_per_s": B * S / warm,
           "peak_mem_mb": peak / 2**20, "kernel": kernel,
           "launches_per_forward": launches,
           "launches_in_three_forwards": total,
           "max_abs_err_vs_plain": err, "plain_ok": plain_ok, **prof,
           "finite": bool(torch.isfinite(logits).all()),
           "shape_ok": tuple(logits.shape) == (B, S, model.cfg.vocab)}
    rec["ok"] = (launches == n and total == 3 * n and plain_ok
                 and rec["finite"] and rec["shape_ok"])
    return logits, rec


def held_to_reference(logits, positions, expected) -> dict:
    """``forward_summary`` of ``logits`` at ``positions`` against the
    reference's ``expected`` under ``forward_agrees``' rule."""
    summary = forward_summary(logits[:, list(positions)].float().cpu()
                              .numpy())
    return {"summary": summary,
            "max_sum_rel_err_vs_reference": max(
                abs(s[1] - e[1]) / abs(e[1])
                for s, e in zip(summary, expected)),
            "reference_ok": forward_agrees(summary, expected)}


def model_phase(dev):
    """smollm-135m, full width and depth, float32, NumPy-seeded weights:
    the 2048-token forward through the flash kernel, held to the plain
    version's forward and to the reference's logits.  Returns (model,
    tokens, logits of the first 8 positions) for the decode phase."""
    import torch
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.train.data import SyntheticDataset

    cfg = get_arch("smollm-135m")
    t0 = time.perf_counter()
    model = interop.model_params(cfg, interop.seeded_params(cfg, seed=0),
                                 device=dev)
    toks = SyntheticDataset(cfg.vocab, 2048, 2, seed=0).batch(0)["tokens"]
    toks = toks.to(dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    logits, rec = run_forward(model, toks, "flash_attention",
                              "model/smollm-135m/forward-2048")
    rec.update(load_s=load_s, **held_to_reference(logits, HELD_POSITIONS,
                                                  EXPECTED_FORWARD))
    rec["ok"] = rec["ok"] and rec["reference_ok"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the smollm-135m forward failed its checks")
    return model, toks, logits[:, :8].clone()


def mamba2_cut_phase(dev) -> None:
    """mamba2-2.7b at full width with its depth cut to two layers,
    float32, NumPy-seeded weights: a B 2 x 256 forward through the
    ``ssd_scan`` kernel (one launch per layer), held to the reference's
    logits (``EXPECTED_MAMBA2``)."""
    import dataclasses
    import torch
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import reset_launches
    from repro_torch.train.data import SyntheticDataset

    cfg = dataclasses.replace(get_arch("mamba2-2.7b"), n_layers=2)
    t0 = time.perf_counter()
    model = interop.model_params(cfg, interop.seeded_params(cfg, seed=0),
                                 device=dev)
    toks = SyntheticDataset(cfg.vocab, 256, 2, seed=0).batch(0)["tokens"]
    toks = toks.to(dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with torch.inference_mode():
        reset_launches()
        t0 = time.perf_counter()
        logits = model(toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _count_path(("ssd_scan",))["ssd_scan"]
    rec = held_to_reference(logits, MAMBA2_HELD_POSITIONS, EXPECTED_MAMBA2)
    B, S = toks.shape
    ok = (launches == cfg.n_layers and rec["reference_ok"]
          and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (B, S, cfg.vocab))
    emit({"phase": "model/mamba2-2.7b/forward-256-L2", "dtype": "float32",
          "batch": B, "seq": S, "layers": cfg.n_layers, "load_s": load_s,
          "cold_s": wall, "ssd_scan_launches": launches, **rec, "ok": ok})
    if not ok:
        raise AssertionError("the cut-depth mamba2-2.7b forward failed its "
                             "checks")


def mamba2_phase(dev):
    """mamba2-2.7b at full width and depth (64 layers), float32, weights
    drawn on the card from seed 0: the B 2 x 2048 forward through the
    ``ssd_scan`` kernel, held to the plain version's forward.  Returns
    (model, tokens, logits of the first 8 positions) for the decode
    phase."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.train.data import SyntheticDataset

    cfg = get_arch("mamba2-2.7b")
    t0 = time.perf_counter()
    model = M.init(cfg, seed=0, device=dev)
    toks = SyntheticDataset(cfg.vocab, 2048, 2, seed=0).batch(0)["tokens"]
    toks = toks.to(dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    logits, rec = run_forward(model, toks, "ssd_scan",
                              "model/mamba2-2.7b/forward-2048")
    rec["load_s"] = load_s
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the mamba2-2.7b forward failed its checks")
    return model, toks, logits[:, :8].clone()


def decode_phase(model, toks, fwd_logits, steps: int = 8) -> None:
    """``steps`` decode steps from empty caches, each held to the
    forward's logits at the same position (atol = rtol = 1e-4); then the
    same steps again, timed without the checks, and once more under the
    profiler."""
    import torch
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    B = toks.shape[0]
    caches = init_cache(model.cfg, B, steps, device=model.device)
    err, ok = 0.0, True
    for t in range(steps):
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        ok &= bool(torch.allclose(got[:, 0], fwd_logits[:, t], atol=1e-4,
                                  rtol=1e-4))
        err = max(err, float((got[:, 0] - fwd_logits[:, t]).abs().max()))

    def run():
        c = init_cache(model.cfg, B, steps, device=model.device)
        for t in range(steps):
            decode_step(model, c, toks[:, t:t + 1], t)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    key = f"model/{model.cfg.name}/decode-{steps}"
    emit({"phase": key, "batch": B, "steps": steps, "s": wall,
          "ms_per_step": wall / steps * 1e3, **profiled(run, key),
          "max_abs_err_vs_forward": err, "ok": ok})
    if not ok:
        raise AssertionError("decode disagrees with the forward")


def serve_phase(arch: str = "smollm-135m") -> None:
    """The port's serve driver with the reference's default arguments, on
    ``cuda``: it must return 0; its printed times are read back."""
    import contextlib
    import io
    import re
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32",
            "--gen", "16"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    secs = [float(x) for x in re.findall(r"in ([0-9.]+)s", out)]
    ok = rc == 0 and len(secs) == 2 and len(out.splitlines()) == 3
    emit({"phase": f"serve/{arch}", "argv": argv, "rc": rc,
          "wall_s": wall, "prefill_s": secs[0] if ok else None,
          "decode_s": secs[1] if ok else None,
          "prefill_tok_per_s": 32 * 4 / secs[0] if ok and secs[0] else None,
          "decode_tok_per_s": 16 * 4 / secs[1] if ok and secs[1] else None,
          "output": out.splitlines(), "ok": ok})
    if not ok:
        raise AssertionError("the serve driver failed")


# -------------------------------------------------------------------- main
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text("".join(
        f"== {name}\n{log}\n" for name, log in _build.BUILD_LOGS.items()))
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})
    emit({"phase": "build/ptxas",
          "instances": ptxas_report(_build.BUILD_LOGS)})

    failed = []
    try:
        t0 = time.perf_counter()
        kernel_phase(dev)
        emit({"phase": "kernels/done", "s": time.perf_counter() - t0,
              "checked": ["swap_select", "torus_hop", "fattree_hop"]})
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels")
    model_recs = {}
    try:
        t0 = time.perf_counter()
        model_recs = model_kernel_phase(dev)
        entry_point_phase(dev)
        emit({"phase": "kernels/model/done", "s": time.perf_counter() - t0})
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels/model")
    torch.cuda.empty_cache()
    try:
        model, toks, fwd_logits = model_phase(dev)
        decode_phase(model, toks, fwd_logits)
        del model, toks, fwd_logits
        torch.cuda.empty_cache()
        serve_phase()
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("model")
    torch.cuda.empty_cache()
    try:
        mamba2_cut_phase(dev)
        torch.cuda.empty_cache()
        model, toks, fwd_logits = mamba2_phase(dev)
        decode_phase(model, toks, fwd_logits)
        del model, toks, fwd_logits
        torch.cuda.empty_cache()
        serve_phase("mamba2-2.7b")
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("mamba2")
    torch.cuda.empty_cache()
    for run in placement_phases():
        try:
            run()
        except Exception:                   # reported, and the run fails
            traceback.print_exc()
            failed.append("place")
    try:
        paper_phase("cuda")
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("paper")
    for name, n in MAIN_PATH_LAUNCHES.items():
        if n == 0:
            failed.append(f"{name} never launched on the main path")
    records = {}
    try:
        records = main_shape_phase(dev)
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels/main-shape")

    records.update(model_recs)
    summary = []
    for name, meta in KERNELS.items():
        rec = records.get(name, {})
        summary.append({"name": name, "route": "cuda", **meta,
                        "launches": MAIN_PATH_LAUNCHES[name],
                        "shape": MAIN_PATH_SHAPES[name],
                        "max_abs_err": rec.get("max_abs_err"),
                        "ms": rec.get("ms"), "host_ms": rec.get("host_ms"),
                        "plain_ms": rec.get("plain_ms"),
                        "bound_ms": rec.get("bound_ms"),
                        "bound_by": rec.get("bound_by"),
                        "library_ms": rec.get("library_ms")})
    emit({"kernels": summary})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        failed.append("nvidia-smi")
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
