"""Run a function on several ``gloo`` ranks of the torch port, on the CPU,
or in a process of its own.

    results = run_ranks("test_torch_parallel", "job", 4, tmp_path, seconds=240)
    result = run_alone("test_torch_launch", "job", tmp_path, seconds=240)

Each rank is a spawned process (never the pytest worker itself) that
imports ``module``, starts a process group of ``world`` ranks through a
``file://`` rendezvous in ``tmp_path`` (no port: xdist workers run side
by side), runs ``module.<name>(rank, world, tmp_path)`` on one thread,
and writes what it returns (or its traceback) to ``tmp_path``.  Every
group has a 60 s collective timeout, and the join has a deadline: a
rank that is still running then is killed and the test fails, so a hang
never runs into the suite's own clock.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback
import json
import subprocess
from datetime import timedelta
from pathlib import Path


def _entry(module: str, name: str, rank: int, world: int, tmp: str,
           sys_path: list) -> None:
    sys.path[:] = sys_path
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        import importlib

        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
            world_size=world, timeout=timedelta(seconds=60))
        try:
            result = getattr(importlib.import_module(module), name)(
                rank, world, Path(tmp))
        finally:
            dist.destroy_process_group()
        out.write_bytes(pickle.dumps(("ok", result)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise SystemExit(1)


def run_ranks(module: str, name: str, world: int, tmp_path: Path, *,
              seconds: float) -> list:
    """``module.<name>``'s return value on each of ``world`` ranks, in
    rank order; raises ``AssertionError`` with the first failing rank's
    traceback, or when the ranks outlive ``seconds``."""
    tmp = Path(tmp_path) / f"ranks_{name}"
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    env_threads = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",)}
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_entry,
                             args=(module, name, r, world, str(tmp),
                                   list(sys.path)))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in env_threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + seconds
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(world):
        f = tmp / f"rank{r}.pkl"
        status, value = (pickle.loads(f.read_bytes()) if f.exists()
                         else ("error", f"rank {r} wrote no result "
                               f"(exit code {procs[r].exitcode})"))
        if status != "ok" and not hung:
            raise AssertionError(f"rank {r} failed:\n{value}")
        results.append(value)
    if hung:
        raise AssertionError(f"ranks {hung} still ran after {seconds} s; "
                             f"killed")
    return results


def run_alone(module: str, name: str, tmp_path: Path, *, seconds: float):
    """``module.<name>(out)`` in a fresh Python process (for state that is
    process-wide: a fake process group), which writes JSON to the path
    ``out``; returns it.  The child sees the port and the reference on
    its path; it fails the test with its output's tail when it fails, and
    is killed after ``seconds``."""
    root = Path(__file__).resolve().parents[1]
    out = Path(tmp_path) / f"{name}.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join(
        [str(root / "src"), str(root / "tests")])}
    r = subprocess.run(
        [sys.executable, "-c",
         f"import {module} as m; m.{name}({str(out)!r})"],
        capture_output=True, text=True, env=env, cwd=root, timeout=seconds)
    if r.returncode != 0:
        raise AssertionError(f"{module}.{name} failed:\n"
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    return json.loads(out.read_text())
