"""Build variants of the ``ssd_scan`` CUDA source and compare them on the card.

    python3 tools/ssd_scan_variants.py [SOURCE.cu ...]

Each source (by default the package's ``ssd_scan.cu``; every variant must
export the same C entry points) is compiled alone with the port's ``nvcc``
flags, and the wall time of that build and ptxas's register and spill
report are printed.  Then every variant runs the same inputs: mamba2-2.7b's
prefill scan (B 2, H 80, G 1, S 2048, P 64, N 128) at chunk 64 and 128 in
float32 and at chunk 64 in bfloat16, and the reduced mamba2's (B 2, H 8,
P 16, N 16, chunk 8).  Device times are CUDA events around 20 calls,
median of 5, taken in the order first, ..., last, last, ..., first; each
variant's figure is the mean of its two.  Outputs are compared with the
first variant's.  One JSON line per build and per shape, then the card's
name and power limit.  Needs a CUDA GPU and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (B, H, G, S, P, N, chunk, dtype)
CASES = [(2, 80, 1, 2048, 64, 128, 64, "float32"),
         (2, 80, 1, 2048, 64, 128, 128, "float32"),
         (2, 80, 1, 2048, 64, 128, 64, "bfloat16"),
         (2, 8, 1, 64, 16, 16, 8, "float32")]


def build(src: Path, out_dir: Path, tag: str):
    from repro_torch.kernels import _build
    out = out_dir / f"{tag}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
    print(json.dumps({"build": tag, "source": str(src), "nvcc_s": wall,
                      "instances": len(regs), "registers": regs,
                      "spill_store_bytes": max(spills, default=0)}),
          flush=True)
    lib = ctypes.CDLL(str(out))
    for name in ("ssd_scan_f32", "ssd_scan_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def inputs(case):
    import torch
    import torch.nn.functional as F
    B, H, G, S, P, N, chunk, dt = case
    tdt = getattr(torch, dt)
    g = torch.Generator(device="cuda").manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=g, device="cuda")
    xdt = (rand(B, H, S, P) * 0.5).to(tdt)
    dA = -F.softplus(rand(B, H, S)) * 0.5
    Bm, Cm = ((rand(B, G, S, N) * 0.5).to(tdt) for _ in range(2))
    return xdt, dA, Bm, Cm


def caller(lib, case, xdt, dA, Bm, Cm):
    import torch
    B, H, G, S, P, N, chunk, dt = case
    fn = lib.ssd_scan_f32 if dt == "float32" else lib.ssd_scan_bf16
    y = torch.empty_like(xdt)
    st = torch.empty((B, H, P, N), dtype=torch.float32, device="cuda")

    def run():
        err = fn(xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), st.data_ptr(), B, H, G, S, P, N, chunk,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {lib.error_string(err)}")
    return run, y, st


def device_ms(run, reps: int = 20, trials: int = 5) -> float:
    import torch
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    sources = [Path(a) for a in (argv if argv is not None else sys.argv[1:])] \
        or [_build.SOURCES["ssd_scan"]]
    out_dir = Path(tempfile.mkdtemp(prefix="ssd_variants_",
                                    dir=_build.BUILD_DIR.parent
                                    if _build.BUILD_DIR.parent.is_dir()
                                    else None))
    libs = [build(src, out_dir, f"v{i}") for i, src in enumerate(sources)]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for case in CASES:
        data = inputs(case)
        runs = [caller(lib, case, *data) for lib in libs]
        times = {i: [] for i in range(len(libs))}
        for i in order:
            times[i].append(device_ms(runs[i][0]))
        _, y0, st0 = runs[0]
        for i, (_, y, st) in enumerate(runs):
            diff = max(float((y.float() - y0.float()).abs().max()),
                       float((st - st0).abs().max()))
            print(json.dumps({"variant": f"v{i}", "case": list(case),
                              "ms": statistics.mean(times[i]),
                              "ms_each": times[i],
                              "max_abs_diff_vs_v0": diff}), flush=True)
        del data, runs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
