"""Build variants of a CUDA kernel source and compare them on the card.

    python3 tools/ssd_scan_variants.py
        [--kernel ssd_scan|flash_attention|hop_dist|swap_gain] [SOURCE.cu ...]

Each source (by default the package's own source of the kernel; every
variant exports the kernel's C entry points) is compiled alone with the
port's ``nvcc`` flags, and the wall time of that build and ptxas's register
and spill report are printed.  Then every variant runs the same inputs:

* ``ssd_scan``: mamba2-2.7b's prefill scan (B 2, H 80, G 1, S 2048, P 64,
  N 128) at chunk 64 and 128 in float32 and bfloat16, and the reduced
  mamba2's (B 2, H 8, P 16, N 16, chunk 8).  A source that exports
  ``ssd_scan_workspace_floats`` takes the workspace and stage count of the
  chunk-parallel interface; one that does not, the one-launch interface
  that came before it.
* ``flash_attention``: smollm-135m's prefill (2, 9, 3, 2048, 2048, 64)
  causal in bfloat16 and float32, and the MLA-width (1, 16, 16, 1024,
  1024, 192) causal in bfloat16.
* ``hop_dist``: ``torus_hop`` on a (32, 32, 16) torus and ``fattree_hop``
  on a k 32 fat tree, integer coordinates, float64 and float32, at the
  implicit placement path's largest shape (2, 512, 512), the two shapes it
  launches most often (chunk refines of one candidate), the implicit
  cells' shape at 1024 ranks (2, 1024, 1024) and TOFA's 16-candidate
  stack (16, 1024, 1024).  These launches last microseconds, so they are
  timed as ``chip_smoke.py`` times a kernel (``cuda_ms``: calls queued
  behind a spin kernel, so the host's launch cost stays out), and each
  output is also compared with the plain version's.
* ``swap_gain``: the gains row (``swap_gain_f32`` / ``swap_gain_f64``) on
  integer-valued inputs, mover n // 3, float32 and float64, at the dense
  guest's (1024, 1024), the largest dense guest's (4096, 4096), ragged n
  (1, 33, 1023, 1025) and (1024, 1024) as a view one value past a 16-byte
  boundary; timed L2-hot as ``hop_dist`` is, and at (1024, 1024) also
  L2-cold (``chip_smoke.cold_ms``: a 128 MB write before each call, the
  events around the call alone).  Each line carries the launch floor
  (``torch.cuda._sleep(0)`` timed the same way, hot and, for the cold
  cases, cold) and the byte bound, and whether the output equals the plain
  version's bit for bit.

Device times are CUDA events around 20 calls, median of 5, taken in the
order first, ..., last, last, ..., first; each variant's figure is the
mean of its two.  Outputs are compared with the first variant's (largest
absolute difference, and whether they are equal bit for bit).  One JSON
line per build and per case, then the card's name and power limit.  Needs
a CUDA GPU and ``nvcc``.
"""
from __future__ import annotations

import argparse
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
sys.path.insert(0, str(ROOT))
from chip_smoke import HBM_BYTES_PER_S, cold_ms, cuda_ms  # noqa: E402

CASES = {
    # (B, H, G, S, P, N, chunk, dtype)
    "ssd_scan": [(2, 80, 1, 2048, 64, 128, 64, "float32"),
                 (2, 80, 1, 2048, 64, 128, 128, "float32"),
                 (2, 80, 1, 2048, 64, 128, 64, "bfloat16"),
                 (2, 80, 1, 2048, 64, 128, 128, "bfloat16"),
                 (2, 8, 1, 64, 16, 16, 8, "float32")],
    # (B, H, Hkv, Sq, Sk, Dh, causal, dtype)
    "flash_attention": [(2, 9, 3, 2048, 2048, 64, 1, "bfloat16"),
                        (1, 16, 16, 1024, 1024, 192, 1, "bfloat16"),
                        (2, 9, 3, 2048, 2048, 64, 1, "float32")],
    # (kernel, B, m, k, dtype)
    "hop_dist": [(name, *shape, dt)
                 for dt in ("float64", "float32")
                 for name in ("torus_hop", "fattree_hop")
                 for shape in ((2, 512, 512), (1, 4, 4), (1, 8, 8),
                               (2, 1024, 1024), (16, 1024, 1024))],
    # (n, L2 cold, offset in values, dtype)
    "swap_gain": [(n, cold, off, dt)
                  for dt in ("float32", "float64")
                  for n, cold, off in ((1024, False, 0), (1024, True, 0),
                                       (4096, False, 0), (1, False, 0),
                                       (33, False, 0), (1023, False, 0),
                                       (1025, False, 0), (1024, False, 1))],
}
HOP_TORUS = (32, 32, 16)
HOP_FATTREE = (32, 16, 16)     # (pod, edge, host) extents of k 32
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def build(src: Path, out_dir: Path, tag: str, kernel: str):
    from repro_torch.kernels import _build
    out = out_dir / f"{tag}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           *_build.INCLUDE_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    names = re.findall(r"Compiling entry function '([^']+)'", log)
    spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
    print(json.dumps({"build": tag, "source": str(src), "nvcc_s": wall,
                      "instances": len(regs), "registers": regs,
                      "names": names,
                      "spill_store_bytes": spills}), flush=True)
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    if kernel == "swap_gain":
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"swap_gain_{dt}")
            fn.argtypes = [_P] * 5 + [_I64, _P]
            fn.restype = ctypes.c_int
        return lib
    if kernel == "hop_dist":
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"torus_hop_{dt}")
            fn.argtypes = [_P] * 3 + [_I64] * 3 + [ctypes.c_int] \
                + [ctypes.c_double] * 4 + [_P]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"fattree_hop_{dt}")
            fn.argtypes = [_P] * 3 + [_I64] * 3 + [_P]
            fn.restype = ctypes.c_int
        return lib
    if kernel == "flash_attention":
        # sources from the backward on take an lse pointer after o
        lib.with_lse = "void* lse" in Path(src).read_text()
        for name in ("flash_attention_f32", "flash_attention_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * (5 if lib.with_lse else 4) + [_I64] * 6 \
                + [ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        return lib
    staged = hasattr(lib, "ssd_scan_workspace_floats")
    for name in ("ssd_scan_f32", "ssd_scan_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = ([_P] * 7 + [_I64] * 7 + [ctypes.c_int, _P] if staged
                       else [_P] * 6 + [_I64] * 7 + [_P])
        fn.restype = ctypes.c_int
    if staged:
        lib.ssd_scan_workspace_floats.argtypes = [_I64] * 6
        lib.ssd_scan_workspace_floats.restype = _I64
    lib.staged = staged
    return lib


def inputs(kernel: str, case):
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=g, device="cuda")
    tdt = getattr(torch, case[-1])
    if kernel == "swap_gain":
        import numpy as np
        n, _, off, _ = case
        rng = np.random.default_rng(0)
        A = rng.integers(0, 7, (n, n))
        S = rng.integers(0, 5, (n, n)) * (rng.random((n, n)) < 0.3)

        def placed(a):          # a view ``off`` values into its storage
            buf = torch.empty(n * n + off, dtype=tdt, device="cuda")
            view = buf[off:].view(n, n)
            view.copy_(torch.tensor(a, dtype=tdt))
            return view
        M, G = placed(A + A.T), placed(S + S.T)
        return M, G, (G * M).sum(-1), torch.tensor([n // 3], device="cuda")
    if kernel == "hop_dist":
        import numpy as np
        name, B, m, k, _ = case
        ext = HOP_TORUS if name == "torus_hop" else HOP_FATTREE
        rng = np.random.default_rng(1)
        return tuple(torch.tensor(np.stack([rng.integers(0, e, (B, n))
                                            for e in ext], -1),
                                  dtype=tdt, device="cuda")
                     for n in (m, k))
    if kernel == "flash_attention":
        B, H, Hkv, Sq, Sk, Dh, _, _ = case
        return (rand(B, H, Sq, Dh).to(tdt), rand(B, Hkv, Sk, Dh).to(tdt),
                rand(B, Hkv, Sk, Dh).to(tdt))
    B, H, G, S, P, N, _, _ = case
    xdt = (rand(B, H, S, P) * 0.5).to(tdt)
    dA = -F.softplus(rand(B, H, S)) * 0.5
    Bm, Cm = ((rand(B, G, S, N) * 0.5).to(tdt) for _ in range(2))
    return xdt, dA, Bm, Cm


def caller(lib, kernel: str, case, data):
    """(run, outputs) of one variant on one case."""
    import torch
    stream = lambda: torch.cuda.current_stream().cuda_stream
    f32 = case[-1] == "float32"
    if kernel == "swap_gain":
        M, G, contrib, iv = data
        o = torch.empty(case[0], dtype=M.dtype, device="cuda")
        fn = lib.swap_gain_f32 if f32 else lib.swap_gain_f64
        args = lambda: (M.data_ptr(), G.data_ptr(), contrib.data_ptr(),
                        iv.data_ptr(), o.data_ptr(), case[0], stream())
        outs = (o,)
    elif kernel == "hop_dist":
        name, B, m, k, _ = case
        cu, cv = data
        o = torch.empty((B, m, k), dtype=cu.dtype, device="cuda")
        fn = getattr(lib, f"{name}_{'f32' if f32 else 'f64'}")
        extra = ((len(HOP_TORUS), *map(float, HOP_TORUS), 0.0)
                 if name == "torus_hop" else ())
        args = lambda: (cu.data_ptr(), cv.data_ptr(), o.data_ptr(), B, m,
                        k, *extra, stream())
        outs = (o,)
    elif kernel == "flash_attention":
        B, H, Hkv, Sq, Sk, Dh, causal, _ = case
        q, k, v = data
        o = torch.empty_like(q)
        fn = lib.flash_attention_f32 if f32 else lib.flash_attention_bf16
        lse = (None,) if lib.with_lse else ()
        args = lambda: (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), *lse, B, H, Hkv, Sq, Sk, Dh, causal,
                        stream())
        outs = (o,)
    else:
        B, H, G, S, P, N, chunk, _ = case
        xdt, dA, Bm, Cm = data
        y = torch.empty_like(xdt)
        st = torch.empty((B, H, P, N), dtype=torch.float32, device="cuda")
        fn = lib.ssd_scan_f32 if f32 else lib.ssd_scan_bf16
        head = (xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), st.data_ptr())
        dims = (B, H, G, S, P, N, chunk)
        if lib.staged:
            ws = torch.empty(lib.ssd_scan_workspace_floats(B, H, S, P, N,
                                                           chunk),
                             dtype=torch.float32, device="cuda")
            args = lambda: (*head, ws.data_ptr(), *dims, 3, stream())
        else:
            args = lambda: (*head, *dims, stream())
        outs = (y, st)

    def run():
        err = fn(*args())
        if err:
            raise RuntimeError(f"launch failed: {lib.error_string(err)}")
    return run, outs


def plain(kernel: str, case, data):
    """The plain version's outputs, where the comparison is exact."""
    from repro_torch.kernels.hop_dist.ref import (fattree_hop_pairs_ref,
                                                  torus_hop_pairs_ref)
    from repro_torch.kernels.swap_gain.ref import swap_gain_ref
    if kernel == "swap_gain":
        M, G, contrib, iv = data
        return (swap_gain_ref(M[None], G, contrib[None], iv)[0],)
    if kernel != "hop_dist":
        return None
    if case[0] == "torus_hop":
        return (torus_hop_pairs_ref(*data, HOP_TORUS),)
    return (fattree_hop_pairs_ref(*data),)


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(CASES), default="ssd_scan")
    ap.add_argument("sources", nargs="*", type=Path)
    args = ap.parse_args(argv)
    sources = args.sources or [_build.SOURCES[args.kernel]]
    out_dir = Path(tempfile.mkdtemp(prefix="variants_",
                                    dir=_build.BUILD_DIR.parent
                                    if _build.BUILD_DIR.parent.is_dir()
                                    else None))
    libs = [build(src, out_dir, f"v{i}", args.kernel)
            for i, src in enumerate(sources)]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    # microsecond launches: the empty launch's time, and each case's bound
    floor = (cuda_ms(lambda: torch.cuda._sleep(0))[0]
             if args.kernel in ("hop_dist", "swap_gain") else None)
    cold_floor = (cold_ms(lambda: torch.cuda._sleep(0))[0]
                  if args.kernel == "swap_gain" else None)
    for case in CASES[args.kernel]:
        data = inputs(args.kernel, case)
        runs = [caller(lib, args.kernel, case, data) for lib in libs]
        times = {i: [] for i in range(len(libs))}
        cold = args.kernel == "swap_gain" and case[1]
        for i in order:
            # launches of microseconds: time the card alone, as chip_smoke
            times[i].append(cold_ms(runs[i][0])[0] if cold
                            else cuda_ms(runs[i][0])[0]
                            if floor is not None
                            else device_ms(runs[i][0]))
        extra = {}
        if floor is not None:
            extra["launch_floor_ms"] = floor
        if cold:
            extra["launch_floor_cold_ms"] = cold_floor
        if args.kernel == "swap_gain":
            n, size = case[0], data[0].element_size()
            extra["bound_ms"] = ((2 * n * n + 2 * n) * size + 8) \
                / HBM_BYTES_PER_S * 1e3
        ref = runs[0][1]
        want = plain(args.kernel, case, data)
        for i, (_, outs) in enumerate(runs):
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(outs, ref))
            equal = all(bool(torch.equal(a, b)) for a, b in zip(outs, ref))
            print(json.dumps({"kernel": args.kernel, "variant": f"v{i}",
                              "case": list(case),
                              "ms": statistics.mean(times[i]),
                              "ms_each": times[i],
                              "max_abs_diff_vs_v0": diff,
                              "bit_equal_to_v0": equal, **extra,
                              **({} if want is None else {
                                  "bit_equal_to_plain": all(
                                      bool(torch.equal(a, b))
                                      for a, b in zip(outs, want))})}),
                  flush=True)
        del data, runs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
