"""Where a dry-run cell's collectives come from.

Traces one cell as ``python -m repro_torch.launch.dryrun`` does (a fake
process group of 256 ranks, fake CPU tensors, no placement analysis) and
sums each collective's network bytes a GPU (the row's
``collectives_by_kind`` arithmetic) by kind and by the line of the port
that issued it: the innermost two frames outside the profiler and the
sharding helpers; for a collective of the backward, ``BWD``, the
autograd node and the forward line that made it (autograd's anomaly mode
records each node's forward stack, which slows the trace):

    PYTHONPATH=src python tools/dryrun_collectives.py --arch mamba2-2.7b \\
        --shape train_4k [--out collectives.json]

It prints the ``TOP`` largest groups; the JSON keeps them all.

The figures are a CPU trace, not a device measurement.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import traceback

_SKIP = ("core/profiler.py", "parallel/sharding.py")
TOP = 25


def _lines(frames) -> str:
    """The innermost two ``repro_torch`` frames (path:line) outside
    ``_SKIP``, innermost first."""
    port = [(f, n) for f, n in frames if not f.endswith(_SKIP)]
    return " < ".join(f"{f}:{n}" for f, n in port[-2:][::-1])


def _issued_at() -> str:
    import torch
    node = torch._C._current_autograd_node()
    if node is not None:
        stack = "".join(node.metadata.get("traceback_", []))
        return f"BWD {node.name()} " + _lines(re.findall(
            r'File ".*?repro_torch/([^"]+)", line (\d+)', stack))
    return _lines([(fr.filename.split("repro_torch/")[-1], fr.lineno)
                   for fr in traceback.extract_stack()[:-1]
                   if "repro_torch/" in fr.filename])


def trace_collectives(arch: str, shape: str) -> dict:
    import torch

    from repro_torch.core import profiler
    from repro_torch.launch.dryrun import run_cell

    by = collections.defaultdict(float)
    record = profiler._Recorder.record

    def recording(self, func, args, kwargs, out):
        n = len(self.collectives)
        res = record(self, func, args, kwargs, out)
        for c in self.collectives[n:]:
            by[(c.kind, _issued_at())] += (c.per_device_network_bytes
                                           * c.multiplier)
        return res

    profiler._Recorder.record = recording
    try:
        with torch.autograd.detect_anomaly(check_nan=False):
            run_cell(arch, shape, multi_pod=False, placement_analysis=False,
                     verbose=False)
    finally:
        profiler._Recorder.record = record
    rows = [{"bytes": b, "kind": k, "at": at}
            for (k, at), b in sorted(by.items(), key=lambda kv: -kv[1])]
    return {"arch": arch, "shape": shape,
            "collective_bytes": sum(by.values()), "by_line": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    res = trace_collectives(args.arch, args.shape)
    print(f"{args.arch} x {args.shape}: "
          f"{res['collective_bytes'] / 1e9:.2f} GB of collectives a GPU")
    for r in res["by_line"][:TOP]:
        print(f"{r['bytes'] / 1e9:10.2f} GB  {r['kind']:15s} {r['at']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
