"""Sharding rules: logical parameter/activation axes -> mesh axes, on a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

The model schemas tag every tensor dimension with a logical axis name;
this module maps those names onto mesh axes, as the reference's
``repro.parallel.sharding`` does, and places tensors as DTensors.  One
rule table covers every architecture:

  vocab / heads / kv_heads / mlp / experts / ssm_inner  -> "model"   (TP/EP)
  embed                                                 -> "data"    (FSDP)
  batch                                                 -> ("pod", "data")
  cache_seq                                             -> "model"   (decode)

A dimension is only sharded if its size divides the mesh-axis size;
otherwise it falls back to replication, unless its logical axis is in
``pad_shard_axes`` and the dimension is at least as large as the axis,
where it becomes DTensor's uneven ``Shard`` (the last shards short, as
GSPMD's padding leaves them).

    ctx = ShardingCtx(mesh=init_device_mesh("cuda", (2, 2),
                                            mesh_dim_names=("data", "model")))
    ctx.distribute(model)                  # nn.Parameters -> DTensors
    logits = model(ctx.place(tokens, ("batch", "seq")), ctx=ctx)

A spec is a plain tuple, one entry per tensor dimension: ``None``, a mesh
axis name, or a tuple of mesh axis names (the reference's
``PartitionSpec``, trailing ``None`` stripped).  ``mesh=None`` is the
single-device path: every helper is then a no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, object] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "embed": "data",          # FSDP: weights gathered per layer
    "lora": None,
    "layers": None,
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "cache_seq": "model",
    "cache_heads": None,
    "vis_seq": None,
}

# pure-FSDP layout: no tensor parallelism — batch over every mesh axis,
# weights fully sharded on their embed dim and gathered per layer.  The
# layout for archs whose head/ff dims divide the model axis poorly
# (smollm 9 heads, minicpm 40 heads, starcoder 36).
FSDP_RULES: dict[str, object] = {
    **DEFAULT_RULES,
    "vocab": None,
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "experts": None,
    "ssm_inner": None,
    "embed": ("data", "model"),
    "batch": ("pod", "data", "model"),
    "cache_seq": None,
}

LAYOUTS = {"tp": DEFAULT_RULES, "fsdp": FSDP_RULES}


def _mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``), or of any object whose ``shape`` is such a dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@dataclasses.dataclass
class ShardingCtx:
    """Mesh + rules + helpers.  ``mesh=None`` => single device."""

    mesh: Optional[object] = None
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))
    moe_impl: str = "replicated"   # replicated | alltoall | auto
    remat: bool = True
    # logical axes allowed to shard unevenly when the dim does not divide
    # the mesh axis (e.g. 40 heads over 16 shards: shards of 3, the last
    # of 0)
    pad_shard_axes: tuple = ()
    # decode attention over a model-sharded KV cache by flash-decoding
    # (partial softmax per shard + one max and two sum reductions)
    flash_decode: bool = False

    # ------------------------------------------------------------ axis math
    @property
    def shape(self) -> dict[str, int]:
        return {} if self.mesh is None else _mesh_shape(self.mesh)

    def _axis_size(self, mesh_axes) -> int:
        if self.mesh is None:
            return 1
        if isinstance(mesh_axes, str):
            return self.shape[mesh_axes]
        return math.prod(self.shape[a] for a in mesh_axes)

    def spec_for(self, axes: tuple, shape: tuple | None = None) -> tuple:
        """Logical axes tuple -> spec (with divisibility checks)."""
        parts = []
        used: set = set()
        mesh_shape = self.shape
        for i, ax in enumerate(axes):
            mesh_axes = self.rules.get(ax) if ax else None
            if mesh_axes is None:
                parts.append(None)
                continue
            flat = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            if self.mesh is not None:
                # drop axes absent from this mesh (e.g. "pod" on single-pod)
                flat = tuple(a for a in flat if a in mesh_shape)
            if not flat or any(a in used for a in flat):
                parts.append(None)  # a mesh axis may appear only once
                continue
            mesh_axes = flat[0] if len(flat) == 1 else flat
            if self.mesh is not None and shape is not None:
                sz = self._axis_size(mesh_axes)
                if shape[i] % sz != 0:
                    # uneven sharding only where opted-in and dim >= axis
                    if not (ax in self.pad_shard_axes and shape[i] >= sz):
                        parts.append(None)
                        continue
            parts.append(mesh_axes)
            used.update(flat)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def placements_of(self, spec: Sequence) -> list:
        """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` on
        each mesh axis that tensor dim ``d`` names, ``Replicate()`` on the
        others.  A dim sharded over several mesh axes takes them in the
        mesh's order (``("data", "model")`` on a data x model mesh), the
        only order DTensor's ``Shard`` can express."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.shape)
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            flat = (entry,) if isinstance(entry, str) else tuple(entry)
            pos = [names.index(a) for a in flat]
            if pos != sorted(pos):
                raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                                 f"axis order {tuple(names)}")
            for p in pos:
                out[p] = Shard(dim)
        return out

    def placements_for(self, axes: tuple, shape: tuple | None = None) -> list:
        """Logical axes -> DTensor placements (:meth:`spec_for`, then
        :meth:`placements_of`)."""
        return self.placements_of(self.spec_for(axes, shape))

    # ------------------------------------------------------------ tensors
    def place(self, t: torch.Tensor, axes: tuple):
        """A full tensor, the same on every rank, as a DTensor placed by
        ``axes``: each rank keeps its own chunk, no collective.  No-op
        without a mesh."""
        if self.mesh is None or is_dtensor(t):
            return t
        from torch.distributed.tensor import distribute_tensor
        t = t.to(self.mesh.device_type)
        return distribute_tensor(t, self.mesh,
                                 self.placements_for(axes, tuple(t.shape)),
                                 src_data_rank=None)

    def distribute(self, model: nn.Module) -> nn.Module:
        """Replace each parameter of a ``Transformer`` with a DTensor
        parameter placed by its ``ParamDef`` (a layer's slice takes the
        stacked leaf's axes without the leading ``"layers"``), in place;
        returns the model.  Every rank must hold the same weights: each
        keeps its own chunk.  No-op without a mesh."""
        if self.mesh is None:
            return model
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.models.model import param_leaves
        for name, _, layer, d in param_leaves(model.cfg):
            axes, shape = ((d.axes, d.shape) if layer is None
                           else (d.axes[1:], d.shape[1:]))
            *parents, leaf = name.split(".")
            owner = model.get_submodule(".".join(parents))
            p = getattr(owner, leaf)
            dt = distribute_tensor(p.detach(), self.mesh,
                                   self.placements_for(axes, shape),
                                   src_data_rank=None)
            setattr(owner, leaf,
                    nn.Parameter(dt, requires_grad=p.requires_grad))
        return model

    def scope(self):
        """The context a sharded forward runs in: plain tensors met among
        DTensors (rope tables, masks) act as replicated
        (``implicit_replication``).  A null context without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _replicating()

    # ------------------------------------------------------------ act utils
    def constrain(self, x, *axes):
        """Redistribute a DTensor activation to the placement ``axes``
        give it (no-op without a mesh)."""
        if self.mesh is None:
            return x
        return x.redistribute(self.mesh,
                              self.placements_for(axes, tuple(x.shape)))

    def spread_entry(self, B: int):
        """The spec entry of a batch dim of size ``B`` split over the batch
        axes and the ``"model"`` axis too, where B divides them all (each
        rank keeps whole rows of its own), else :meth:`batch_entry`."""
        axes = tuple(a for a in self.shape
                     if a in self.batch_axes() or a == "model")
        if not axes or B % self._axis_size(axes):
            return self.batch_entry(B)
        return axes[0] if len(axes) == 1 else axes

    def spread_batch(self, x):
        """An activation (B, ...) placed by :meth:`spread_entry`: the
        residual stream between layers that the reference leaves
        unconstrained (a mamba2 layer, an encoder-decoder model's decoder
        layer), so that a rank keeps only its own rows of each
        checkpointed layer input.  No-op without a mesh."""
        if self.mesh is None:
            return x
        return x.redistribute(self.mesh, self.placements_of(
            (self.spread_entry(x.shape[0]),)))

    def head_entry(self, *counts: int):
        """The spec entry of a heads dim a kernel runs over: the mesh axes
        the ``"heads"`` rule names when each of ``counts`` (query heads,
        KV heads, SSM groups) divides their size, so that each rank's
        query heads meet their own KV heads or groups; else None (every
        rank computes every head)."""
        entry = self.query_head_entry(counts[0])
        if entry is None or any(c % self._axis_size(entry) for c in counts):
            return None
        return entry

    def query_head_entry(self, H: int):
        """The spec entry of a query heads dim of ``H`` heads: the mesh
        axes the ``"heads"`` rule names when ``H`` divides their size,
        whatever the KV heads do (each rank then meets the KV heads of
        its own query heads: ``models.layers``' attention); else None."""
        entry = self.spec_for(("heads",), (H,))
        if not entry or H % self._axis_size(entry[0]):
            return None
        return entry[0]

    def local_range(self, entry, size: int) -> tuple[int, int, list]:
        """This rank's part of a dim of ``size`` split by the spec entry
        ``entry`` (DTensor's ``Shard``: ``torch.chunk``, axis by axis in
        the entry's order): (its first index, its length, the process
        groups of the entry's axes of more than one rank)."""
        lo, n, groups = 0, size, []
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            k = self.shape[a]
            if k > 1:
                chunk = -(-n // k)
                c = self.mesh.get_local_rank(a)
                lo += c * chunk
                n = max(0, min(chunk, n - c * chunk))
                groups.append(self.group(a))
        return lo, n, groups

    def column_steps(self, entry, token_spec: Sequence) -> list:
        """The steps of :func:`lookup_by_columns` and
        :func:`matmul_by_columns` for a table whose columns the spec
        entry ``entry`` splits, met by tokens placed by ``token_spec``:
        for each of the entry's axes of more than one rank, outermost
        first, (its process group, its size, whether it also splits the
        tokens, this rank's index on it)."""
        tokens = self.spec_axes(token_spec)
        return [(self.group(a), self.shape[a], a in tokens,
                 self.mesh.get_local_rank(a))
                for a in ((entry,) if isinstance(entry, str)
                          else entry or ()) if self.shape[a] > 1]

    def batch_entry(self, B: int):
        """The spec entry of a batch dim of size ``B``."""
        entry = self.spec_for(("batch",), (B,))
        return entry[0] if entry else None

    @property
    def model_axis_size(self) -> int:
        return self.shape.get("model", 1)

    def batch_axes(self) -> tuple:
        """Mesh axes that shard the batch dim."""
        r = self.rules.get("batch")
        if r is None or self.mesh is None:
            return ()
        flat = (r,) if isinstance(r, str) else tuple(r)
        return tuple(a for a in flat if a in self.shape)

    def group(self, axis: str):
        """The process group of mesh axis ``axis``."""
        return self.mesh.get_group(axis)

    def call_block(self, block, *args, **kwargs):
        """``block(*args, **kwargs)``, under activation checkpointing when
        a mesh is set, ``remat`` is on and grad is enabled (the
        reference's ``_maybe_remat``: the backward recomputes the block's
        activations; no value changes)."""
        if self.mesh is not None and self.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            def scoped(*a, **k):      # the recompute runs in the backward
                with self.scope():
                    return block(*a, **k)
            return checkpoint(scoped, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)

    def kernel_map(self, fn, specs: Sequence[Sequence], out_spec: Sequence,
                   *tensors, partial: Optional[Sequence] = None):
        """Run ``fn`` (a kernel entry point, or any function of plain
        tensors) on each rank's shards of DTensor ``tensors``, each
        redistributed to its spec in ``specs`` first; the result is a
        DTensor placed by ``out_spec``, or, with a list of specs, a tuple
        of DTensors placed by them (``local_map``).  ``partial`` gives,
        for each input, the mesh axes over which its gradient is a
        partial sum (a weight replicated over an axis that splits the
        tokens it meets), summed when the gradient is redistributed; the
        gradient is placed as its input elsewhere.  Plain tensors go to
        ``fn`` as they are."""
        if not tensors or not is_dtensor(tensors[0]):
            return fn(*tensors)
        from torch.distributed.tensor import Partial
        from torch.distributed.tensor.experimental import local_map
        in_pl = tuple(self.placements_of(s) for s in specs)
        grads = None
        if partial is not None:
            grads = []
            for pl, axes in zip(in_pl, partial):
                pl = list(pl)
                for i, a in enumerate(self.shape):
                    if a in axes:
                        pl[i] = Partial()
                grads.append(pl)
            grads = tuple(grads)
        out = (tuple(self.placements_of(o) for o in out_spec)
               if isinstance(out_spec, list) else self.placements_of(out_spec))
        return local_map(
            fn, out_placements=out,
            in_placements=in_pl, in_grad_placements=grads,
            device_mesh=self.mesh, redistribute_inputs=True)(*tensors)

    def spec_axes(self, spec: Sequence) -> tuple:
        """The mesh axes a spec shards over."""
        return tuple(a for e in spec if e is not None
                     for a in ((e,) if isinstance(e, str) else e))

NULL_CTX = ShardingCtx(mesh=None)


def pad_shards(x: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, pad)`` with zeros; a DTensor is padded on each rank's
    own shard and keeps its placements (DTensor's own ``constant_pad_nd``
    fails to redistribute its input in some torch releases).  Padding is
    linear, so a ``Partial`` input pads as well as a sharded one; the
    padded dims must not be sharded."""
    if not is_dtensor(x):
        return F.pad(x, pad)
    dims = {x.ndim - 1 - i // 2 for i in range(len(pad))}
    if any(pl.is_shard(d) for pl in x.placements for d in dims):
        raise ValueError(f"pad {tuple(pad)} reaches a sharded dim of "
                         f"{x.placements}")
    from torch.distributed.tensor.experimental import local_map
    pl = list(x.placements)
    return local_map(lambda t: F.pad(t, pad), out_placements=pl,
                     in_placements=(pl,), device_mesh=x.device_mesh)(x)


class SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) of partial outputs whose sum every rank then uses
    alike; the gradient of each partial is the gradient of the sum, which
    each rank already holds whole, so the backward passes it on as it
    is."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _collective(name: str, t, *args, group):
    """The functional collective ``name`` (``torch.ops._c10d_functional``)
    of ``t`` over ``group``, waited for."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(getattr(c10d, name)(t.contiguous(), *args,
                                                 group.group_name))


def _gather(t, group):
    """The group's ``t`` stacked along dim 0, in group order."""
    return _collective("all_gather_into_tensor", t, group.size(),
                       group=group)


def _exchange(t, group):
    """All-to-all along dim 0: chunk j of ``t`` goes to group rank j; the
    result's chunk j came from rank j."""
    split = [t.shape[0] // group.size()] * group.size()
    return _collective("all_to_all_single", t, split, split, group=group)


def _columns(t, n: int) -> torch.Tensor:
    """``t``'s dim-0 chunks, one from each of ``n`` ranks, side by side
    along the last dim."""
    return torch.cat(t.chunk(n, 0), dim=-1)


class _LookupByRows(torch.autograd.Function):
    """Rows ``w[ids - lo]`` of a table of which this rank holds rows
    ``lo`` .. ``lo + len(w) - 1``, zero rows for the ids outside them,
    summed over ``groups`` (:func:`lookup_by_rows`).  Only the ids are
    kept for the backward, which recomputes which of them hit."""

    @staticmethod
    def forward(fctx, w, ids, lo, groups):
        hit = (ids >= lo) & (ids < lo + w.shape[0])
        rows = w[torch.where(hit, ids - lo, 0)].masked_fill_(
            ~hit[..., None], 0)
        for g in groups:
            rows = _collective("all_reduce", rows, "sum", group=g)
        fctx.lo, fctx.shape = lo, w.shape
        fctx.save_for_backward(ids)
        return rows

    @staticmethod
    def backward(fctx, g):
        (ids,) = fctx.saved_tensors
        hit = (ids >= fctx.lo) & (ids < fctx.lo + fctx.shape[0])
        gw = torch.zeros(fctx.shape, dtype=g.dtype, device=g.device)
        gw.index_put_((torch.where(hit, ids - fctx.lo, 0),),
                      g.masked_fill(~hit[..., None], 0), accumulate=True)
        return gw, None, None, None


def lookup_by_rows(w: torch.Tensor, ids: torch.Tensor, lo: int,
                   groups: Sequence) -> torch.Tensor:
    """The rows ``table[ids]`` (ids (b, ...) -> (b, ..., d)), where this
    rank holds the table's rows ``lo`` .. ``lo + len(w) - 1`` (``w``, whole
    columns) and ``groups`` are the process groups over which the rows are
    split: each rank looks up the ids in its range, zero rows for the
    others, and the rows are summed over the groups (an all-reduce of one
    row and zeros: the table's rows bit for bit).  The gradient of each
    rank's rows comes from its own ids; the gradient of the rows, whole on
    every rank, is passed on as it is (:class:`SumOverGroup`'s rule)."""
    return _LookupByRows.apply(w, ids, lo, tuple(groups))


class _LookupByColumns(torch.autograd.Function):
    """Rows ``w[ids]`` of a table of which this rank holds the column
    slice ``w`` (V, d_local), whole rows built by moving token ids and
    looked-up columns, never the table (:func:`lookup_by_columns`)."""

    @staticmethod
    def forward(fctx, w, ids, steps):
        def fwd(ids, level):
            if level == len(steps):
                return w[ids]
            group, n, split, _ = steps[level]
            if split:           # the group's tokens differ: trade columns
                rows = fwd(_gather(ids, group), level + 1)
                return _columns(_exchange(rows, group), n)
            return _columns(_gather(fwd(ids, level + 1), group), n)

        fctx.steps, fctx.shape = steps, w.shape
        fctx.save_for_backward(ids)
        return fwd(ids, 0)

    @staticmethod
    def backward(fctx, g):
        # the ids are gathered again (a few integers) rather than kept
        (ids,) = fctx.saved_tensors
        for group, n, split, i in fctx.steps:
            parts = g.chunk(n, -1)
            # the forward's exchange backwards; a replicated gradient's own
            # columns where the forward gathered looked-up columns
            if split:
                ids = _gather(ids, group)
                g = _exchange(torch.cat(parts, 0), group)
            else:
                g = parts[i]
        gw = torch.zeros(fctx.shape, dtype=g.dtype, device=g.device)
        gw.index_put_((ids,), g, accumulate=True)
        return gw, None, None


def lookup_by_columns(w: torch.Tensor, ids: torch.Tensor,
                      steps: Sequence) -> torch.Tensor:
    """The rows ``table[ids]`` (ids (b, ...) -> (b, ..., d)), where this
    rank holds the columns ``w`` (V, d_local) of the table and
    :meth:`ShardingCtx.column_steps` describes how they are split.  On an
    axis that splits the tokens, the ids are gathered, each rank looks up
    its columns for all of them, and one all-to-all gives each rank its
    own tokens' columns; on an axis that does not, the looked-up columns
    are gathered.  The rows are copies of the table's, bit for bit; the
    gradient is ``w``'s slice of the table's, summed over the tokens of
    the ranks that split them."""
    return _LookupByColumns.apply(w, ids, tuple(steps))


def matmul_by_columns(x: torch.Tensor, w: torch.Tensor,
                      steps: Sequence) -> torch.Tensor:
    """``x @ table.T`` (x (b, ..., d) -> (b, ..., V)) where this rank
    holds the columns ``w`` (V, d_local) of the table, split as
    :meth:`ShardingCtx.column_steps` says: the activations move, never
    the table.  On an axis that splits the tokens, one all-to-all gives
    each rank its group's tokens on its own columns, and the partial
    products are summed and scattered back (reduce-scatter); on one that
    does not, each rank's partial product is summed (all-reduce).  The
    products sum over d in another order than one matmul.  No autograd
    (the collectives run outside it)."""
    if not steps:
        return x @ w.T
    (group, n, split, i), rest = steps[0], steps[1:]
    if split:
        part = matmul_by_columns(
            _exchange(torch.cat(x.chunk(n, -1), 0), group), w, rest)
        return _collective("reduce_scatter_tensor", part, "sum", n,
                           group=group)
    part = matmul_by_columns(x.chunk(n, -1)[i], w, rest)
    return _collective("all_reduce", part, "sum", group=group)


# how deep the scopes of sharded runs are nested on this thread: the inner
# ones (a checkpointed block's recompute, inside the backward of a step)
# must not end the outer one, and ``implicit_replication`` does not nest
_DEPTH = 0


@contextlib.contextmanager
def _replicating():
    global _DEPTH
    if _DEPTH:
        _DEPTH += 1
        try:
            yield
        finally:
            _DEPTH -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        _DEPTH = 1
        try:
            yield
        finally:
            _DEPTH = 0


def make_mesh(device_type: str, shape: tuple,
              names: tuple = ("data", "model")):
    """A ``DeviceMesh`` of ``shape`` over the process group already
    started (``torch.distributed.init_process_group``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)
