"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

For each cell this script:
  1. starts a fake process group of the mesh's world size (256 ranks for
     the 16x16 single-pod mesh, 512 for 2x16x16 multi-pod; this process
     is rank 0, no collective leaves it) and builds the production
     ``DeviceMesh``;
  2. builds the cell's step (train step / prefill forward / decode step)
     with ``ShardingCtx`` on that mesh, the model, optimizer state,
     caches and batch made as fake CPU tensors (``FakeTensorMode``: shapes
     only, no storage is ever allocated) shaped as ``abstract_cache`` /
     ``input_specs`` give them, and placed as DTensors;
  3. traces one step (``core.profiler.profile_torch``): any sharding rule
     or spec that DTensor cannot run fails HERE, which is the point;
  4. reports the per-device memory (does it fit the H100's 80 GB?), the
     FLOPs and HBM bytes, the three roofline terms on the H100 data
     sheet's rates, and the placement-aware hop-bytes (linear vs TOFA on
     the H100 fabric, placed on ``--device``).

The fake tensors are CPU tensors, so every kernel entry point takes its
plain version, as it does for any CPU tensor: the trace reads the plain
flash-attention and SSD versions, whose traffic the kernel-ideal memory
term replaces (``memory_s_kernel``).  The row has the reference's keys
(``repro.launch.dryrun``) where the quantity exists: ``lower_s`` is the
trace's seconds; there is no compile step, so ``compile_s`` and XLA's own
``xla_flops`` are left out.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun.json
  python -m repro_torch.launch.dryrun --arch mamba2-2.7b --shape long_500k \
      --device cpu            # placement analysis on the CPU
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, shape_cells
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.profiler import fake_mode, profile_torch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (HBM_BW, HBM_BYTES, Roofline,
                                         ideal_attention_bytes,
                                         model_flops_for, placement_terms)
from repro_torch.models import model as M
from repro_torch.parallel.sharding import LAYOUTS, ShardingCtx
from repro_torch.serve.decode import decode_step
from repro_torch.serve.kvcache import abstract_cache, cache_schema
from repro_torch.train.data import input_specs
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (collectives compute shapes only and reach no one), destroyed
    on exit.  The group is process-wide: one at a time."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already started in this "
                           "process; the dry run needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(meta: torch.Tensor) -> torch.Tensor:
    """A fake CPU tensor shaped as a ``meta`` stand-in (call under the
    fake mode)."""
    return torch.empty(meta.shape, dtype=meta.dtype, device="cpu")


def build_cell(cfg, shape_cfg, mesh, *, moe_impl="replicated", remat=True,
               state_dtype=torch.float32, param_dtype=torch.bfloat16,
               rules_override=None, pad_shard_axes=(), flash_decode=False,
               layout="tp"):
    """-> (fn, args): the cell's step and its arguments, every tensor a
    DTensor on ``mesh``.  Call under :func:`~repro_torch.core.profiler.
    fake_mode` (nothing is allocated).  The parameters are the model's
    own, made in ``param_dtype``; the batch (``input_specs``) and the
    caches (``abstract_cache``) are placed by their logical axes."""
    ctx = ShardingCtx(mesh=mesh, moe_impl=moe_impl, remat=remat,
                      pad_shard_axes=tuple(pad_shard_axes),
                      flash_decode=flash_decode,
                      rules=dict(LAYOUTS[layout]))
    if rules_override:
        ctx.rules.update(rules_override)
    model = ctx.distribute(M.Transformer(cfg, device="cpu",
                                         dtype=param_dtype))
    B, S = shape_cfg.global_batch, shape_cfg.seq_len

    def placed_batch():
        return {k: ctx.place(_fake(v), ("batch", "seq") if v.ndim == 2
                             else ("batch", "seq", "act_embed"))
                for k, v in input_specs(cfg, shape_cfg,
                                        dtype=param_dtype).items()}

    if shape_cfg.kind == "train":
        opt = AdamW(state_dtype=state_dtype)
        return (make_train_step(cfg, opt, ctx),
                (model, opt.init(model), placed_batch()))

    if shape_cfg.kind == "prefill":
        def fwd(model, batch):
            with torch.no_grad():
                return model(batch["tokens"],
                             vision_embed=batch.get("vision_embed"),
                             enc_embed=batch.get("enc_embed"), ctx=ctx)
        return fwd, (model, placed_batch())

    # decode: one new token against a seq_len-deep cache
    src_len = cfg.n_vision_tokens if cfg.family == "vlm" else \
        (cfg.n_audio_frames or 512 if cfg.family == "encdec" else None)
    sch = cache_schema(cfg, B, S, src_len=src_len)
    caches = {grp: {name: ctx.place(_fake(t), sch[grp][name].axes)
                    for name, t in leaves.items()}
              for grp, leaves in abstract_cache(cfg, B, S, dtype=param_dtype,
                                                src_len=src_len).items()}
    tok = ctx.place(torch.zeros((B, 1), dtype=torch.int32), ("batch", None))

    def dec(model, caches, tok):
        return decode_step(model, caches, tok, S - 1, ctx=ctx)
    return dec, (model, caches, tok)


def _launches() -> dict:
    from repro_torch.kernels import LAUNCHES
    return dict(LAUNCHES)


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             placement_analysis: bool = True, verbose: bool = True,
             device=None, comm_out=None, **build_kw) -> dict:
    """Trace one cell on its own fake process group and return its row;
    the placement analysis runs on ``device`` (``cuda`` when omitted).
    ``comm_out``: a directory to write the cell's guest graph to
    (``<arch>__<shape>__<mesh>.npz``: ``G_v``, ``G_m``)."""
    from repro_torch.core.profiler import comm_graph_from_profile
    cfg = get_arch(arch)
    shape_cfg = SHAPES[shape]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_dev = 512 if multi_pod else 256
    with fake_process_group(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = time.time()
        with fake_mode():
            fn, args = build_cell(cfg, shape_cfg, mesh, **build_kw)
        prof = profile_torch(fn, *args, mesh=mesh)
        t_trace = time.time() - t0
        del fn, args

    rf = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_dev,
        flops=prof.flops, bytes_accessed=prof.bytes_accessed,
        collective_bytes=prof.collective_bytes,
        model_flops=model_flops_for(cfg, shape_cfg, n_dev))

    row = rf.row()
    # kernel-adjusted memory term: the flash/SSD kernels keep their block
    # intermediates on chip; substitute ideal q/k/v/o traffic for the
    # traffic tagged in the plain versions (see
    # roofline.ideal_attention_bytes)
    tagged = sum(prof.bytes_by_tag.values())
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    bpd = shape_cfg.global_batch
    for ax in ("pod", "data"):
        if ax in mesh_shape and bpd % mesh_shape[ax] == 0:
            bpd //= mesh_shape[ax]
    hpd = cfg.n_heads or 1
    if "model" in mesh_shape and hpd and hpd % mesh_shape["model"] == 0:
        hpd //= mesh_shape["model"]
    ideal = ideal_attention_bytes(cfg, shape_cfg, bpd, hpd)
    mem_kernel_s = max(prof.bytes_accessed - tagged + ideal, 0.0) / HBM_BW
    row.update({
        "ok": True,
        "bytes_tagged_kernelizable": tagged,
        "bytes_kernel_ideal": ideal,
        "memory_s_kernel": mem_kernel_s,
        "lower_s": round(t_trace, 2),
        "arg_bytes_per_dev": prof.arg_bytes,
        "temp_bytes_per_dev": prof.temp_bytes,
        "total_bytes_per_dev": prof.peak_bytes,
        "fits_hbm": bool(prof.peak_bytes <= HBM_BYTES),
        "collectives_by_kind": prof.collective_bytes_by_kind(),
        "moe_impl": build_kw.get("moe_impl", "replicated"),
    })
    if comm_out is not None:
        comm = comm_graph_from_profile(prof)
        path = Path(comm_out) / f"{arch}__{shape}__{mesh_name}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, G_v=comm.G_v, G_m=comm.G_m)
    if placement_analysis:
        before = _launches()
        try:
            pt = placement_terms(prof, multi_pod, device=device)
            if pt:
                row["placement"] = {k: {"hop_bytes": v["hop_bytes"],
                                        "avg_dilation": v["avg_dilation"]}
                                    for k, v in pt.items()}
        except Exception as e:  # pragma: no cover
            row["placement_error"] = str(e)
        row["placement_launches"] = {k: n - before[k] for k, n
                                     in _launches().items() if n > before[k]}

    if verbose:
        gb = prof.peak_bytes / 1e9
        print(f"[{arch} x {shape} @ {mesh_name}] "
              f"trace={t_trace:.1f}s "
              f"mem/dev={gb:.2f}GB "
              f"fits_hbm={row['fits_hbm']} "
              f"compute={rf.compute_s*1e3:.2f}ms "
              f"memory={rf.memory_s*1e3:.2f}ms "
              f"collective={rf.collective_s*1e3:.2f}ms "
              f"mem_kernel={mem_kernel_s*1e3:.2f}ms "
              f"dominant={rf.dominant} "
              f"useful={rf.useful_flops_ratio:.2f} "
              f"roofline={rf.roofline_fraction:.1%}")
        print(f"  memory: args={prof.arg_bytes:.4g} B "
              f"temp={prof.temp_bytes:.4g} B peak={prof.peak_bytes:.4g} B")
        print(f"  traced: flops={prof.flops:.3e} bytes="
              f"{prof.bytes_accessed:.3e} collectives="
              f"{len(prof.collectives)}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Trace (arch x shape x mesh) cells on a fake process "
                    "group and report their roofline rows.")
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="sweep every live (arch x shape) cell")
    ap.add_argument("--multi-pod", choices=("on", "off", "both"),
                    default="off")
    ap.add_argument("--moe-impl", default="replicated",
                    choices=("replicated", "alltoall", "auto"))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--state-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--pad-heads", action="store_true",
                    help="allow padded head sharding (40 heads over 16 "
                         "shards: shards of 3, the last short, instead of "
                         "replicating)")
    ap.add_argument("--flash-decode", action="store_true",
                    help="flash-decoding over the model-sharded KV cache "
                         "(decode cells)")
    ap.add_argument("--layout", default="tp", choices=("tp", "fsdp"),
                    help="sharding layout: tp (TP+FSDP default) or pure fsdp")
    ap.add_argument("--tag", default=None,
                    help="experiment tag recorded in the output rows")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--device", default="cuda",
                    help="where the placement analysis runs (cuda | cpu)")
    ap.add_argument("--comm-out", default=None,
                    help="write each cell's guest graph (.npz) here")
    args = ap.parse_args(argv)

    pods = {"on": [True], "off": [False],
            "both": [False, True]}[args.multi_pod]
    if args.all:
        cells = [(a, s) for a in sorted(ARCHS)
                 for s in shape_cells(get_arch(a))]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    build_kw = dict(moe_impl=args.moe_impl, remat=not args.no_remat,
                    state_dtype=getattr(torch, args.state_dtype),
                    pad_shard_axes=(("heads", "kv_heads")
                                    if args.pad_heads else ()),
                    flash_decode=args.flash_decode, layout=args.layout)
    failures = 0
    rows = []
    for arch, shape in cells:
        if shape not in shape_cells(get_arch(arch)):
            print(f"[{arch} x {shape}] SKIPPED (cell not live for family)")
            continue
        for mp in pods:
            try:
                row = run_cell(arch, shape, multi_pod=mp, device=args.device,
                               comm_out=args.comm_out, **build_kw)
                if args.tag:
                    row["tag"] = args.tag
                rows.append(row)
            except Exception:
                failures += 1
                print(f"[{arch} x {shape} @ multi_pod={mp}] FAILED")
                traceback.print_exc()
                rows.append({"arch": arch, "shape": shape,
                             "mesh": "2x16x16" if mp else "16x16",
                             "ok": False,
                             "error": traceback.format_exc(limit=1)})
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"\n{len(rows) - failures}/{len(rows)} cells traced OK")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
