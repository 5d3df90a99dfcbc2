"""Trace every live dry-run cell, several side by side, and say for each
whether it traced, in how many seconds, at how many bytes a GPU, and
what is live at its peak.

Each cell runs ``tools/dryrun_peak.py`` in a process of its own (the fake
process group is process-wide) with a time limit; a cell that raises is
recorded with its exception and the innermost frame of the port that it
passed through:

    PYTHONPATH=src python tools/dryrun_sweep.py --jobs 6 --out sweep/ \\
        [--timeout 2400] [--cells smollm-135m:train_4k mamba2-2.7b:long_500k]

Two sweeps side by side (bytes a GPU and trace seconds, cell by cell;
the second's bytes and roofline terms against the first's):

    python tools/dryrun_sweep.py --compare cpu/sweep.jsonl card/sweep.jsonl

``sweep/sweep.jsonl`` gets one line a cell, as each ends: ``arch``,
``shape``, ``ok``, ``seconds`` (the process's wall time), ``lower_s``
(the trace's own), ``total_bytes_per_dev``, ``fits_hbm``, the roofline
terms ``compute_s``, ``memory_s``, ``collective_s`` and
``collective_bytes`` (a GPU's, all kinds), ``error`` and ``frame`` for a
failure, and the ``TOP`` largest groups live at the peak;
``sweep/<arch>__<shape>.json`` keeps ``dryrun_peak.py``'s whole record.
The first line names the torch build and, where ``nvidia-smi`` answers,
the card and its power limit.  The figures are CPU traces on fake
tensors, whichever machine runs them.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the slow traces start first: prefill cells, deep models first
_KIND_ORDER = {"prefill": 0, "train": 1, "decode": 2}
# groups live at the peak kept in sweep.jsonl
TOP = 8


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs.base import SHAPES, shape_cells
    from repro_torch.configs.registry import ARCHS, get_arch
    cells = [(a, s) for a in sorted(ARCHS) for s in shape_cells(get_arch(a))]
    return sorted(cells, key=lambda c: (_KIND_ORDER.get(SHAPES[c[1]].kind, 3),
                                        -get_arch(c[0]).n_layers))


def failure(stderr: str) -> tuple[str, str]:
    """The exception line and the innermost ``repro_torch`` frame
    (``path:line function``) of a traceback."""
    lines = [ln for ln in stderr.splitlines() if ln.strip()]
    error = next((ln for ln in reversed(lines)
                  if re.match(r"^[\w.]+(Error|Exception|Exit)\b", ln)),
                 lines[-1] if lines else "")
    frames = re.findall(r'File ".*?repro_torch/([^"]+)", line (\d+), in (\S+)',
                        stderr)
    frame = f"{frames[-1][0]}:{frames[-1][1]} {frames[-1][2]}" if frames else "?"
    return error.strip(), frame


def card() -> str | None:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` says."""
    if not shutil.which("nvidia-smi"):
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(cells, jobs: int, timeout: float, out: Path) -> list:
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    pending, running, rows = list(cells), {}, []
    summary = open(out / "sweep.jsonl", "a")
    try:
        import torch
        head = {"torch": torch.__version__, "card": card(), "jobs": jobs,
                "timeout_s": timeout}
        summary.write(json.dumps(head) + "\n")
        print(json.dumps(head), flush=True)
        while pending or running:
            while pending and len(running) < jobs:
                arch, shape = pending.pop(0)
                dest = out / f"{arch}__{shape}.json"
                err = open(out / f"{arch}__{shape}.err", "w")
                p = subprocess.Popen(
                    [sys.executable, str(HERE / "dryrun_peak.py"), "--arch",
                     arch, "--shape", shape, "--out", str(dest)],
                    env=env, stdout=subprocess.DEVNULL, stderr=err)
                running[p] = (arch, shape, dest, err, time.monotonic())
            time.sleep(0.5)
            for p in list(running):
                arch, shape, dest, err, t0 = running[p]
                wall = time.monotonic() - t0
                if p.poll() is None and wall < timeout:
                    continue
                if p.poll() is None:
                    p.kill()
                    p.wait()
                err.close()
                del running[p]
                row = {"arch": arch, "shape": shape, "seconds": round(wall, 2)}
                if p.returncode == 0 and dest.exists():
                    rec = json.loads(dest.read_text())
                    row.update(ok=True, lower_s=rec["lower_s"],
                               total_bytes_per_dev=rec["total_bytes_per_dev"],
                               arg_bytes_per_dev=rec["arg_bytes_per_dev"],
                               fits_hbm=rec["fits_hbm"],
                               compute_s=rec["compute_s"],
                               memory_s=rec["memory_s"],
                               collective_s=rec["collective_s"],
                               collective_bytes=sum(
                                   rec["collectives_by_kind"].values()),
                               live_at_peak=rec["live_at_peak"][:TOP])
                elif wall >= timeout:
                    row.update(ok=False, error=f"timed out after {timeout} s",
                               frame="?")
                else:
                    error, frame = failure(
                        (out / f"{arch}__{shape}.err").read_text())
                    row.update(ok=False, error=error, frame=frame)
                rows.append(row)
                summary.write(json.dumps(row) + "\n")
                summary.flush()
                gb = (f"{row['total_bytes_per_dev'] / 1e9:.2f} GB"
                      if row["ok"] else f"FAILED {row['error']} at "
                      f"{row['frame']}")
                print(f"{arch} x {shape}: {gb} ({row['seconds']} s)",
                      flush=True)
    finally:
        for p, (*_, err, _t0) in running.items():
            p.kill()
            p.wait()
            err.close()
        summary.close()
    return rows


def load(path) -> dict:
    """(arch, shape) -> a sweep's last line for that cell."""
    rows = (json.loads(line) for line in Path(path).read_text().splitlines())
    return {(r["arch"], r["shape"]): r for r in rows if "arch" in r}


def compare(a_path, b_path) -> None:
    a, b = load(a_path), load(b_path)
    terms = ("total_bytes_per_dev", "compute_s", "collective_s",
             "collective_bytes")

    def cell(r):
        if r is None:
            return "not traced"
        if not r["ok"]:
            return f"FAILED at {r['frame']}"
        return f"{r['total_bytes_per_dev']:.0f} B, {r['lower_s']} s"
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        diff = ""
        if ra and rb and ra["ok"] and rb["ok"]:
            diff = " (" + ", ".join(
                f"{t} {rb[t] / ra[t] - 1:+.2%}" if ra[t] else
                f"{t} {ra[t]:g} -> {rb[t]:g}"
                for t in terms if t in ra and t in rb) + ")"
        print(f"{key[0]} x {key[1]}: {cell(ra)} | {cell(rb)}{diff}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", nargs=2, default=None,
                    metavar=("FIRST", "SECOND"),
                    help="two sweep.jsonl files side by side")
    ap.add_argument("--cells", nargs="*", default=None,
                    help="arch:shape pairs (default: every live cell)")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=2400.0,
                    help="seconds a cell may take")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    if not args.out:
        ap.error("--out is required for a sweep")
    sys.path.insert(0, str(HERE.parent / "src"))
    cells = ([tuple(c.split(":")) for c in args.cells] if args.cells
             else all_cells())
    rows = run(cells, args.jobs, args.timeout, Path(args.out))
    failed = [r for r in rows if not r["ok"]]
    print(f"{len(rows) - len(failed)} of {len(rows)} cells ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
