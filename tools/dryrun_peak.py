"""What is live at a dry-run cell's peak.

Traces one cell as ``python -m repro_torch.launch.dryrun`` does (a fake
process group of 256 ranks, fake CPU tensors, no placement analysis) and
prints the local storages that are live when the step's live bytes
peak, grouped by the line of the port that made each one (storages under
``--min-mb`` are summed as "small"), largest first:

    PYTHONPATH=src python tools/dryrun_peak.py --arch smollm-135m \\
        --shape train_4k [--top 20] [--min-mb 50] [--out peak.json]

The figures are those of ``core.profiler.profile_torch``'s ``peak_bytes``
(the row's ``total_bytes_per_dev``), with the row's roofline terms
(``compute_s``, ``memory_s``, ``collective_s``) and its collective bytes
a GPU by kind: a CPU trace, not a device measurement.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import traceback
import weakref


def _made_at() -> str:
    """The innermost frame of the port outside the profiler."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        if "repro_torch/" in fr.filename \
                and not fr.filename.endswith("core/profiler.py"):
            path = fr.filename.split("repro_torch/")[-1]
            return f"{path}:{fr.lineno} {fr.name}"
    return "?"


def trace_peak(arch: str, shape: str, min_bytes: float) -> dict:
    from repro_torch.core import profiler
    from repro_torch.launch.dryrun import run_cell

    live: dict = {}
    peak = {"bytes": 0.0, "live": []}
    op = [None]
    record, hold = profiler._Recorder.record, profiler._Recorder.hold

    def recording(self, func, args, kwargs, out):
        op[0] = str(func)
        return record(self, func, args, kwargs, out)

    def holding(self, t):
        st = t.untyped_storage()
        before = self.live
        hold(self, t)
        n = self.live - before
        if not n:
            return
        key = id(st)
        live[key] = (n, _made_at() if n >= min_bytes else "small",
                     op[0], tuple(t.shape), str(t.dtype))
        weakref.finalize(st, live.pop, key, None)
        if self.live >= peak["bytes"]:
            peak.update(bytes=self.live, live=list(live.values()))

    profiler._Recorder.record, profiler._Recorder.hold = recording, holding
    try:
        row = run_cell(arch, shape, multi_pod=False,
                       placement_analysis=False, verbose=False)
    finally:
        profiler._Recorder.record, profiler._Recorder.hold = record, hold
    groups = collections.defaultdict(lambda: [0, 0.0, None])
    for n, where, func, shp, dtype in peak["live"]:
        key = (where, "" if where == "small" else func,
               () if where == "small" else shp,
               "" if where == "small" else dtype)
        g = groups[key]
        g[0] += 1
        g[1] += n
    rows = [{"bytes": b, "count": c, "made_at": k[0], "op": k[1],
             "shape": list(k[2]), "dtype": k[3]}
            for k, (c, b, _) in groups.items()]
    rows.sort(key=lambda r: -r["bytes"])
    return {"arch": arch, "shape": shape,
            "total_bytes_per_dev": row["total_bytes_per_dev"],
            "arg_bytes_per_dev": row["arg_bytes_per_dev"],
            "fits_hbm": row["fits_hbm"], "lower_s": row["lower_s"],
            "compute_s": row["compute_s"], "memory_s": row["memory_s"],
            "collective_s": row["collective_s"],
            "collectives_by_kind": row["collectives_by_kind"],
            "live_at_peak": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--min-mb", type=float, default=50.0)
    ap.add_argument("--out", default=None, help="write the groups as JSON")
    args = ap.parse_args(argv)
    res = trace_peak(args.arch, args.shape, args.min_mb * 1e6)
    print(f"{args.arch} x {args.shape}: peak "
          f"{res['total_bytes_per_dev'] / 1e9:.2f} GB a GPU "
          f"(arguments {res['arg_bytes_per_dev'] / 1e9:.3f} GB)")
    for r in res["live_at_peak"][:args.top]:
        print(f"{r['bytes'] / 1e9:10.3f} GB x{r['count']:4d}  "
              f"{r['made_at']}  {r['op']} {tuple(r['shape'])} {r['dtype']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
