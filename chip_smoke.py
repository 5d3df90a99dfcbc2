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
   the placements handed it, and reports those times in the summary line.

Each phase prints one JSON line.  Then come the kernel summary line, the
card's name and power limit, and, only when every phase passed, the final
``{"ok": true, ...}`` line.  Any failure exits non-zero without it.  The
compiler's resource report and the profiler tables go to ``chiprun_out/``.

The script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bandwidth, and the non-tensor-core float32 / float64 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}

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
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    return {"float64": torch.float64, "float32": torch.float32}[name]


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
    for name, shape in MAIN_PATH_SHAPES.items():
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
            row.update(profiled_placement(engine, request, key))
        emit(row)
        if not ok:
            raise AssertionError(f"{key} failed its check")


def profiled_placement(engine, request, key: str) -> dict:
    """One more warm placement under torch.profiler: wall time, summed
    device time of every kernel and copy, and the device idle share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.place(request, policy="tofa", rng=np.random.default_rng(0))
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


MAIN_PATH_LAUNCHES = {"swap_select": 0, "torus_hop": 0, "fattree_hop": 0}
# largest shape each kernel was launched at on the placement phases:
# (B, n) for swap_select, (B, m, k) for the hop kernels
MAIN_PATH_SHAPES = {"swap_select": None, "torus_hop": None,
                    "fattree_hop": None}


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

    failed = []
    try:
        t0 = time.perf_counter()
        kernel_phase(dev)
        emit({"phase": "kernels/done", "s": time.perf_counter() - t0,
              "checked": list(KERNELS)})
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels")
    for run in placement_phases():
        try:
            run()
        except Exception:                   # reported, and the run fails
            traceback.print_exc()
            failed.append("place")
    for name, n in MAIN_PATH_LAUNCHES.items():
        if n == 0:
            failed.append(f"{name} never launched on the main path")
    records = {}
    try:
        records = main_shape_phase(dev)
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels/main-shape")

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
                        "library_ms": None})
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
