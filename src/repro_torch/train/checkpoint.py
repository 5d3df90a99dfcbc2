"""Checkpoint / restore of a model and its AdamW state, in the reference's
on-disk layout (``repro.train.checkpoint``): a checkpoint written by
either package restores in the other.

* every leaf is one ``.npy`` file, beside a JSON manifest that maps each
  leaf's key to ``{file, shape, dtype}`` and also holds the ``step`` and
  ``extra``;
* the leaves are the reference's: each group's layers stacked over a
  leading axis (``params/blocks/wq``), the optimizer's ``opt/.step``,
  ``opt/.m/<path>`` and ``opt/.v/<path>``; saving stacks the model's
  per-layer tensors and restoring slices them again
  (:func:`~repro_torch.models.model.stacked_leaves`,
  :func:`~repro_torch.models.model.unstacked`); a file's name is its key
  with ``/`` written ``__``;
* a bfloat16 leaf is written as the reference writes it, raw 2-byte
  values under the NumPy descr ``<V2`` (``"dtype": "bfloat16"`` in the
  manifest), and read back through ``uint16``: NumPy has no bfloat16;
* the save is atomic (write ``step_XXXXXXXX.tmp``, fsync the manifest,
  rename), so a failure mid-checkpoint never corrupts the latest good
  one; ``keep`` rotation bounds disk use;
* restore checks every leaf's shape against the model's and places the
  leaves on the model's device;
* a model distributed over a mesh (DTensor parameters and moments) is
  saved whole: every rank gathers each leaf, rank 0 alone writes the
  same files as a one-device save, and every rank waits for it;
  ``restore_checkpoint(..., ctx=ctx)`` places each restored leaf by
  ``ctx``, as :meth:`~repro_torch.parallel.sharding.ShardingCtx.
  distribute` placed the parameters.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.model import (Transformer, param_leaves,
                                      stacked_leaves, unstacked)
from repro_torch.parallel.sharding import NULL_CTX, ShardingCtx, is_dtensor
from repro_torch.train.optimizer import AdamWState

# NumPy descr the reference's bfloat16 leaves are written under
_BF16_DESCR = "<V2"


def _save_leaf(path: str, t: torch.Tensor) -> str:
    """Write ``t`` as one ``.npy`` file; returns its manifest dtype."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return str(t.numpy().dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(t.shape)})
        f.write(t.contiguous().view(torch.int16).numpy().tobytes())
    return "bfloat16"


def _load_leaf(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(path)
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _trees(model: Transformer, opt_state: AdamWState | None):
    """(manifest key, tensor) of every leaf to save, in the reference's
    order: the params, then the optimizer's step, m and v."""
    cfg = model.cfg
    whole = lambda ts: {k: t.full_tensor() if is_dtensor(t) else t
                        for k, t in ts.items()}
    for key, t in stacked_leaves(cfg, whole(dict(model.named_parameters()))):
        yield f"params/{key}", t
    if opt_state is not None:
        yield "opt/.step", opt_state.step
        for part in ("m", "v"):
            for key, t in stacked_leaves(cfg, whole(getattr(opt_state,
                                                            part))):
                yield f"opt/.{part}/{key}", t


@torch.no_grad()
def save_checkpoint(directory: str, step: int, model: Transformer,
                    opt_state: AdamWState | None = None, keep: int = 3,
                    extra: dict | None = None) -> str:
    """Atomic save; returns the final checkpoint path.  A distributed
    model is gathered on every rank and written by rank 0."""
    base = os.path.join(directory, f"step_{step:08d}")
    if any(is_dtensor(p) for p in model.parameters()):
        leaves = list(_trees(model, opt_state))      # every rank gathers
        if dist.get_rank() == 0:
            _write(directory, base, step, leaves, keep, extra)
        dist.barrier()
        return base
    _write(directory, base, step, _trees(model, opt_state), keep, extra)
    return base


def _write(directory: str, base: str, step: int, leaves, keep: int,
           extra: dict | None) -> None:
    tmp = base + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, t in leaves:
        fname = key.replace("/", "__") + ".npy"
        dtype = _save_leaf(os.path.join(tmp, fname), t)
        manifest["leaves"][key] = {"file": fname, "shape": list(t.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(base):
        shutil.rmtree(base)
    os.rename(tmp, base)
    _rotate(directory, keep)


def _rotate(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


@torch.no_grad()
def restore_checkpoint(path: str, model: Transformer,
                       opt_like: AdamWState | None = None,
                       ctx: ShardingCtx | None = None) -> dict:
    """Restore the checkpoint at ``path`` into ``model`` (its parameters
    are overwritten in place) and, with ``opt_like``, a new
    :class:`AdamWState` on the model's device, each leaf in the dtype it
    was saved in.  Every leaf's shape is checked against the model's
    before anything is written: a mismatch raises ``ValueError``.  A
    model distributed by ``ctx`` gets each rank's shard of each leaf, the
    moments placed as their parameters.  Returns ``{"step", "params":
    model, "extra"}``, and ``"opt"`` with ``opt_like``."""
    ctx = ctx or NULL_CTX
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    cfg, dev = model.cfg, model.device
    shapes = {"/".join(p): d.shape for _, p, _, d in param_leaves(cfg)}
    names = ["params"] + (["opt/.m", "opt/.v"] if opt_like is not None
                          else [])
    for name in names:
        for key, shape in shapes.items():
            got = tuple(manifest["leaves"][f"{name}/{key}"]["shape"])
            if got != tuple(shape):
                raise ValueError(f"checkpoint leaf {name}/{key}: shape "
                                 f"{got} != {tuple(shape)}")

    def load(name: str) -> dict:
        leaves = {}
        for key in shapes:
            meta = manifest["leaves"][f"{name}/{key}"]
            leaves[key] = _load_leaf(os.path.join(path, meta["file"]), meta)
            if tuple(leaves[key].shape) != tuple(meta["shape"]):
                raise ValueError(f"checkpoint file {meta['file']}: shape "
                                 f"{tuple(leaves[key].shape)} != "
                                 f"{tuple(meta['shape'])}")
        return unstacked(cfg, leaves)

    defs = {name: d.axes if layer is None else d.axes[1:]
            for name, _, layer, d in param_leaves(cfg)}
    params = dict(model.named_parameters())
    if ctx.mesh is None and any(is_dtensor(p) for p in params.values()):
        raise ValueError("restoring into a distributed model needs the ctx "
                         "that distributed it")

    def placed(k: str, t: torch.Tensor) -> torch.Tensor:
        return ctx.place(t.to(dev), defs[k])

    for k, t in load("params").items():
        p = params[k]
        (p.to_local() if is_dtensor(p) else p).copy_(
            placed(k, t).to_local() if is_dtensor(p) else t)
    out = {"step": manifest["step"], "params": model,
           "extra": manifest.get("extra", {})}
    if opt_like is not None:
        meta = manifest["leaves"]["opt/.step"]
        step = _load_leaf(os.path.join(path, meta["file"]), meta)
        out["opt"] = AdamWState(
            step=step.to(dev),
            m={k: placed(k, t) for k, t in load("opt/.m").items()},
            v={k: placed(k, t) for k, t in load("opt/.v").items()})
    return out
