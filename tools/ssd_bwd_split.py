"""Time the SSD scan's backward on the card, launch by launch.

    python3 tools/ssd_bwd_split.py [--reps 5] [--source FILE.cu]

For mamba2-2.7b's (B 2, H 80, G 1, S 2048, P 64, N 128) and zamba2-7b's
(B 2, H 112, G 1, S 2048, P 64, N 64) shapes at chunk 64, in float32 and
bfloat16, on the inputs of ``chip_smoke.check_ssd_bwd`` (seed 4, with a
final-state gradient): the device ms of one ``ops._backward`` call (CUDA
events around ``--reps`` calls behind a spin kernel, median of 3), then
one more call under ``torch.profiler`` with each device kernel's ms by
name (every kernel the call launches: the states it recomputes, the
backward's own launches, casts and copies).  One JSON line per case, then
the card's name and power limit.  ``--source`` builds another variant of
``ssd_scan_bwd.cu`` (the same C entry points) in place of the package's,
so two variants can be timed in one run on one card.  Needs a CUDA GPU
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"mamba2": (2, 80, 1, 2048, 64, 128, 64),
          "zamba2": (2, 112, 1, 2048, 64, 64, 64)}


def inputs(dev, dtype, shape):
    import torch
    import torch.nn.functional as F
    B, H, G, S, P, N, _ = shape
    g = torch.Generator(device=dev).manual_seed(4)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)
    xdt = (rand(B, H, S, P) * 0.5).to(dtype)
    dA = (-F.softplus(rand(B, H, S)) * 0.5).to(dtype)
    Bm, Cm = ((rand(B, G, S, N) * 0.5).to(dtype) for _ in range(2))
    dy = rand(B, H, S, P).to(dtype)
    dst = rand(B, H, P, N)
    return (xdt, dA, Bm, Cm), dy, dst


def device_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1 << 24)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def short(name: str) -> str:
    """A kernel's own name from the profiler's demangled signature."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name[:60]


def split(fn) -> dict:
    """Device ms of each kernel (by name) in one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k = short(e.name())
            out[k] = out.get(k, 0.0) + e.duration_ns() / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--source", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops
    if args.source is not None:
        _build.SOURCES["ssd_scan_bwd"] = args.source.resolve()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops._bwd_lib()
    # ptxas's registers and spill-store bytes of each kernel instance
    # (empty when the library was built before)
    regs = re.findall(r"entry function '\w*?(ssd_bwd_\w+?)E?E?v\w*'.*?"
                      r"(\d+) bytes spill stores.*?Used (\d+) registers",
                      _build.BUILD_LOGS.get("ssd_scan_bwd", ""), re.S)
    print(json.dumps({"source": str(_build.SOURCES["ssd_scan_bwd"]),
                      "build_s": time.perf_counter() - t0,
                      "registers_spills": {k: [int(r), int(sp)]
                                           for k, sp, r in regs}}),
          flush=True)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for cell, shape in SHAPES.items():
            ins, dy, dst = inputs(dev, dtype, shape)
            run = lambda: ops._backward(*ins, dy, dst, shape[-1])
            ms = device_ms(run, args.reps)
            parts = split(run)
            print(json.dumps({"cell": cell, "dtype": dname,
                              "shape": list(shape), "ms": ms,
                              "profiled_ms": sum(parts.values()),
                              "kernels_ms": parts}), flush=True)
            del ins, dy, dst
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
