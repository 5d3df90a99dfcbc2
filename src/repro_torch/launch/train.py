"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --reduced --steps 200 --batch 8 --seq 64 [--device cpu]

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --reduced --mesh 2x2 --device cpu

Composes the stack: config -> model (weights drawn from ``--seed`` on the
target device) -> AdamW (warmup 10 steps) -> optional ``--resume`` from
the latest checkpoint in ``--checkpoint-dir`` -> the train step on
synthetic data (``SyntheticDataset``; the reference's zero stubs for a
VLM's vision embeddings or an encoder-decoder model's frames) ->
checkpoints every ``--checkpoint-every`` steps.  The flags and the log
lines are the reference's (``repro.launch.train``).

``--mesh dxm`` trains sharded over a data x model device mesh of d·m
processes started by ``torchrun`` (its ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and rendezvous address): ``nccl`` on ``cuda``, one card a
process, ``gloo`` only with ``--device cpu``.  Every rank draws the same
weights, the model is distributed by the sharding rules, and rank 0 logs
and writes the checkpoints.  ``--moe-impl`` picks the MoE dispatch under
the mesh (``replicated``: expert-parallel; ``alltoall``; ``auto``: local).
Without ``--mesh`` the run is the one-device one.

On a GPU the step runs through the CUDA kernels both ways: the flash
attention (causal self-attention at 2048 tokens or more) and the SSD scan
(every mamba2 layer) launch their forward kernels under grad and their
backward kernels in the backward (``--arch mamba2-2.7b``, ``--seq 4096``).
"""
from __future__ import annotations

import argparse
import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.backend import resolve_device
from repro_torch.models import model as M
from repro_torch.parallel.sharding import ShardingCtx, make_mesh
from repro_torch.train.checkpoint import (latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import SyntheticDataset, extra_inputs
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step


def build_mesh(spec: str | None, device: torch.device):
    """'dxm' (e.g. '2x4') over the processes ``torchrun`` started, or None
    for one device.  The process group is ``nccl`` on ``cuda`` (each
    process on card ``LOCAL_RANK``) and ``gloo`` on the CPU."""
    if not spec:
        return None
    d, m = (int(x) for x in spec.split("x"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if d * m != world:
        raise SystemExit(f"mesh {spec} needs {d * m} processes, have "
                         f"{world} (launch with torchrun --nproc-per-node "
                         f"{d * m})")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=timedelta(seconds=300))
    return make_mesh(device.type, (d, m))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-sized) variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x model)")
    ap.add_argument("--moe-impl", default="replicated")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = resolve_device(args.device)
    mesh = build_mesh(args.mesh, device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    ctx = ShardingCtx(mesh=mesh, moe_impl=args.moe_impl)
    try:
        return _train(args, cfg, device, ctx)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, cfg, device, ctx: ShardingCtx) -> int:
    # rank 0 logs; every rank of a mesh trains
    log = print if ctx.mesh is None or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    model = ctx.distribute(M.init(cfg, seed=args.seed, device=device))
    opt = AdamW(lr=args.lr, warmup_steps=10)
    opt_state = opt.init(model)

    start_step = 0
    if args.resume and args.checkpoint_dir:
        path = latest_checkpoint(args.checkpoint_dir)
        if path:
            restored = restore_checkpoint(path, model, opt_state, ctx=ctx)
            opt_state = restored["opt"]
            start_step = restored["step"]
            log(f"resumed from {path} at step {start_step}")

    step_fn = make_train_step(cfg, opt, ctx)
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    extras = extra_inputs(cfg, args.batch, seq_len=args.seq, device=device)

    t0 = time.perf_counter()
    tokens_seen = 0
    for step in range(start_step, args.steps):
        batch = ds.batch(step)
        batch.update(extras)
        opt_state, metrics = step_fn(model, opt_state, batch)
        tokens_seen += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start_step:
            dt = time.perf_counter() - t0
            log(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"tok/s {tokens_seen / max(dt, 1e-9):,.0f}")
        if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
            p = save_checkpoint(args.checkpoint_dir, step + 1, model,
                                opt_state)
            log(f"checkpointed -> {p}")
    log(f"done: {args.steps - start_step} steps in "
        f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
