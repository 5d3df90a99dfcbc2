"""Trace every model family's dry-run steps, reduced, on a fake mesh, and
say for each trace whether it ran to its end and which operations made a
4-D tensor over more heads than a rank's own.

Each arch is reduced (d 64, a few layers, the reduced vocab) with its
heads chosen so that they meet the model axis of a 2 x 8 ``tp`` mesh (16
fake ranks) as the full arch's meet the model axis of 16: neither the
query nor the KV heads divide (smollm-135m 9 over 3, starcoder2-7b 12
over 4, minicpm3-4b 12, MLA); the query heads divide and the KV heads do
not (nemotron-4-340b, llama-3.2-vision-11b, phi3.5-moe-42b: 32 over 4);
both divide (seamless-m4t-large-v2 16 over 16, its encoder and
cross-attention over 64 frames; zamba2-7b 16 over 16 and 8 SSD heads;
deepseek-v2-lite-16b 16, MLA; mamba2-2.7b 8 SSD heads).  Each is traced
by ``profile_torch`` at a train step (16 rows, one a rank, as the full
train cells' 256 rows on 256 ranks) and a prefill forward of 2048 tokens
(the flash branch; 2 rows) and a decode step over a 64-deep cache (2
rows), as ``launch.dryrun.build_cell`` builds them.  A process runs one fake group
at a time:

    PYTHONPATH=src python tools/dryrun_families.py --out families.json \\
        [--archs mamba2-2.7b zamba2-7b]

The JSON maps ``<arch>/<kind>`` to ``error`` (the traceback's last
frames, or null) and ``heads``: the (operation, shape) of each 4-D
floating tensor of a train step or a prefill whose second dim is a
heads dim (at most the model's head count: the attention's, or the
SSD's where it has more) over more than a rank's share of the heads that
divide the model axis, and whose rows x heads exceed a rank's share of
both (its rows of the batch split over the data axis, its own heads): a
rank that holds one row of the batch split over both axes may hold all
of that row's heads.  A sequence-first layout, whose second dim is the
sequence or a slice of it, is left out.  The exit code is 1 when a trace
failed or ``heads`` is not empty.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback

MESH, S, B, CACHE, N_SRC = (2, 8), 2048, 2, 64, 64
# a train step's rows split over the data and model axes, as the full
# train_4k cells' 256 over 256 ranks do (a mamba2 layer's conv and the
# residual between layers on each rank's own rows); a prefill's and a
# decode step's B rows split over the data axis only
B_TRAIN = MESH[0] * MESH[1]
FAMILIES = {
    "smollm-135m": dict(n_heads=9, n_kv_heads=3),
    "starcoder2-7b": dict(n_heads=12, n_kv_heads=4),
    "minicpm3-4b": dict(n_heads=12, n_kv_heads=12),
    "nemotron-4-340b": dict(n_heads=32, n_kv_heads=4),
    "llama-3.2-vision-11b": dict(n_heads=32, n_kv_heads=4,
                                 n_vision_tokens=N_SRC),
    "phi3.5-moe-42b": dict(n_heads=32, n_kv_heads=4),
    "seamless-m4t-large-v2": dict(n_heads=16, n_kv_heads=16,
                                  n_audio_frames=N_SRC),
    "zamba2-7b": dict(n_heads=16, n_kv_heads=16),
    "deepseek-v2-lite-16b": dict(n_heads=16, n_kv_heads=16),
    "mamba2-2.7b": {},
}
KINDS = ("train", "prefill", "decode")


def heads(cfg) -> tuple:
    """(a rank's share of the heads that divide the model axis, or None
    where they do not divide; the largest heads dim of the model): the
    attention's heads, an SSM model's SSD heads, a hybrid's larger
    count."""
    ssd = (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
           if cfg.ssm else 0)
    H = ssd if cfg.family == "ssm" else cfg.n_heads
    return (H // MESH[1] if H % MESH[1] == 0 else None), max(H, ssd)


@contextlib.contextmanager
def recording():
    """A list that gets (operation, shape, dtype) of every tensor an
    operation makes while the profiler traces (views, which make no
    storage, left out), so that one that lives only briefly counts."""
    from repro_torch.core import profiler

    made = []
    record = profiler._Recorder.record

    def recorded(self, func, args, kwargs, res):
        if not func.is_view:
            made.extend((str(func), tuple(t.shape), t.dtype)
                        for t in profiler._tensors(res))
        return record(self, func, args, kwargs, res)

    profiler._Recorder.record = recorded
    try:
        yield made
    finally:
        profiler._Recorder.record = record


def trace(archs=None) -> dict:
    """``<arch>/<kind>`` -> {"error", "heads"} for ``archs`` (every family
    when None), traced on one fake group of 16 ranks."""
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.profiler import fake_mode, profile_torch
    from repro_torch.launch.dryrun import build_cell, fake_process_group
    from repro_torch.parallel.sharding import make_mesh

    shapes = {"train": ShapeConfig("t", S, B_TRAIN, "train"),
              "prefill": ShapeConfig("p", S, B, "prefill"),
              "decode": ShapeConfig("d", CACHE, B, "decode")}
    res = {}
    with recording() as made, fake_process_group(MESH[0] * MESH[1]):
        mesh = make_mesh("cpu", MESH)
        for arch in archs or FAMILIES:
            cfg = reduced(get_arch(arch), **FAMILIES[arch])
            own, most = heads(cfg)
            for kind in KINDS:
                rows = shapes[kind].global_batch // MESH[0]
                made.clear()
                try:
                    with fake_mode():
                        fn, args = build_cell(cfg, shapes[kind], mesh)
                    profile_torch(fn, *args, mesh=mesh)
                    error = None
                except Exception:
                    error = traceback.format_exc(limit=-4)
                res[f"{arch}/{kind}"] = {
                    "error": error,
                    "heads": sorted({
                        (op, str(shp)) for op, shp, dt in made
                        if kind != "decode" and own is not None
                        and len(shp) == 4 and dt.is_floating_point
                        and own < shp[1] <= most
                        and shp[0] * shp[1] > rows * own})}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="*", default=None,
                    choices=sorted(FAMILIES))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    res = trace(args.archs)
    with open(args.out, "w") as f:
        json.dump(res, f)
    bad = 0
    for key, r in res.items():
        ok = r["error"] is None and not r["heads"]
        bad += not ok
        print(f"{key}: {'ok' if ok else 'FAILED'}"
              + (f" {r['error'].strip().splitlines()[-1]}" if r["error"]
                 else "") + (f" heads {r['heads']}" if r["heads"] else ""),
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
