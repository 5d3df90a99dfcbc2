"""HLO profiler: the paper's MPI profiling tool, adapted to compiled XLA.

The paper's tool intercepts MPI calls at runtime to build the communication
graph.  An SPMD JAX program declares all of its communication statically in
the compiled HLO, so this profiler *parses* ``compiled.as_text()`` instead of
intercepting calls — same output, zero runtime overhead:

* every collective op (all-reduce / all-gather / reduce-scatter / all-to-all
  / collective-permute / collective-broadcast, sync or async ``-start``
  form) with its replica groups (explicit or iota ``[G,S]<=[dims]T(perm)``
  notation) and operand bytes;
* loop-aware FLOP and HBM-byte accounting: XLA's ``cost_analysis()`` counts a
  ``while`` body ONCE, so a 96-layer ``lax.scan`` under-reports ~96x.  This
  parser extracts the trip count from each loop's condition computation and
  multiplies through (nested loops compose);
* :func:`comm_graph_from_hlo` decomposes each collective over its replica
  groups into point-to-point phases (ring/pairwise/direct) and accumulates
  the same ``G_v``/``G_m`` matrices the paper's PMPI tool produces — this is
  the guest graph handed to TOFA.

The port keeps this parser as it is (it reads HLO text from any XLA
program) and adds its counterpart for PyTorch programs:
:func:`profile_torch` runs one step of a sharded program on fake tensors
(``FakeTensorMode``: shapes, no storage) and reads the same quantities
from the operations it dispatches: each functional collective with its
replica groups over the ``DeviceMesh``, FLOPs and HBM bytes per device,
the bytes of the plain flash-attention and SSD regions, and the peak of
live memory.  It returns the same :class:`HloProfile`, so
:func:`comm_graph_from_profile` and the roofline read either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from collections import defaultdict

import numpy as np
import torch

from .comm_graph import CommGraph

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "s16": 2, "u16": 2, "f16": 2,
    "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
)

# ops that are pure aliasing / bookkeeping — no HBM traffic of their own
_SKIP_BYTES = {
    "parameter", "get-tuple-element", "tuple", "bitcast", "constant",
    "after-all", "partition-id", "replica-id", "opt-barrier", "domain",
    "reshape",
}

# elementwise / layout ops a TPU-grade fusion pass melts into their
# producers/consumers: charging each as an HBM round-trip (the CPU-backend
# HLO leaves them unfused) would overstate the memory term 3-10x.  With
# ``fusion_model=True`` these contribute no traffic of their own — the
# boundary reads/writes are still charged at the non-elementwise ops that
# produce/consume the buffers.
_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "exponential", "exp", "log",
    "log-plus-one", "exponential-minus-one", "tanh", "maximum", "minimum",
    "compare", "select", "convert", "negate", "abs", "rsqrt", "sqrt",
    "power", "and", "or", "not", "xor", "clamp", "floor", "ceil", "sign",
    "cosine", "sine", "logistic", "is-finite", "iota", "broadcast",
    "reverse", "pad", "slice", "remainder", "shift-left",
    "shift-right-logical", "shift-right-arithmetic", "atan2", "cbrt",
    "round-nearest-afz", "round-nearest-even", "real", "imag", "expm1",
    "log1p", "popcnt", "clz", "stochastic-convert", "reduce-precision",
    "map", "bitcast-convert",
}

# metadata op_name substrings attributed as kernel-fusible regions
_TAG_PATTERNS = {"flash": ("flash_attention",),
                 "ssd": ("ssd_chunked",)}

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(?[^(]*?\)?)\s*([\w\-]+)\((.*)$"
)
_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*(.+?)\s*\{\s*$")


def _parse_shapes(type_str: str) -> list[tuple[str, tuple[int, ...]]]:
    """'(f32[4,8]{1,0}, bf16[2])' or 'f32[4,8]{1,0}' -> [(dtype, dims), ...]"""
    out = []
    for m in _SHAPE_RE.finditer(type_str):
        dt = m.group(1)
        if dt not in DTYPE_BYTES and dt != "token":
            continue
        dims = tuple(int(x) for x in m.group(2).split(",") if x)
        out.append((dt, dims))
    return out


def _nbytes(shapes: list[tuple[str, tuple[int, ...]]]) -> float:
    total = 0.0
    for dt, dims in shapes:
        if dt == "token":
            continue
        total += DTYPE_BYTES.get(dt, 4) * float(np.prod(dims)) if dims else \
            DTYPE_BYTES.get(dt, 4)
    return total


@dataclasses.dataclass
class Instruction:
    name: str
    shapes: list  # result shapes [(dtype, dims)]
    op: str
    operands: list  # operand %names (in-paren only)
    attrs: str      # raw text after the closing paren of operands
    raw: str


@dataclasses.dataclass
class CollectiveOp:
    kind: str                     # canonical, e.g. 'all-reduce'
    operand_bytes: float          # per-device operand payload (sum, tuple ok)
    groups: list                  # list of tuples of device ids (or None)
    group_size: int
    multiplier: float             # product of enclosing loop trip counts
    source_target_pairs: list | None = None

    @property
    def per_device_network_bytes(self) -> float:
        """Bytes each participating device sends over the network (ring)."""
        g, s = self.group_size, self.operand_bytes
        if g <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (g - 1) / g * s
        if self.kind == "all-gather":
            return (g - 1) * s
        if self.kind == "reduce-scatter":
            return (g - 1) / g * s
        if self.kind == "all-to-all":
            return (g - 1) / g * s
        if self.kind in ("collective-permute", "collective-broadcast"):
            return s
        return s


@dataclasses.dataclass
class HloProfile:
    flops: float                  # loop-corrected, per device
    bytes_accessed: float         # loop-corrected HBM traffic model, per device
    collectives: list             # list[CollectiveOp], loop-corrected multipliers
    num_partitions: int
    raw_flops: float = 0.0        # body-once flops (cost_analysis convention)
    # bytes attributed to instruction-metadata tags (e.g. 'flash' for the
    # online-softmax attention internals) — lets the roofline substitute a
    # Pallas-kernel traffic model for regions the TPU kernel fuses entirely
    bytes_by_tag: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        """Per-device network bytes across all collectives (x multipliers)."""
        return sum(c.per_device_network_bytes * c.multiplier
                   for c in self.collectives)

    def collective_bytes_by_kind(self) -> dict:
        out = defaultdict(float)
        for c in self.collectives:
            out[c.kind] += c.per_device_network_bytes * c.multiplier
        return dict(out)


# --------------------------------------------------------------------------
# parsing
# --------------------------------------------------------------------------

def parse_computations(hlo_text: str) -> tuple[dict, str, int]:
    """-> ({comp_name: [Instruction]}, entry_name, num_partitions)."""
    comps: dict[str, list[Instruction]] = {}
    entry = None
    num_partitions = 1
    m = re.search(r"num_partitions=(\d+)", hlo_text)
    if m:
        num_partitions = int(m.group(1))
    cur: list[Instruction] | None = None
    cur_name = None
    for line in hlo_text.splitlines():
        cm = _COMP_RE.match(line)
        if cm:
            cur_name = cm.group(2)
            cur = []
            comps[cur_name] = cur
            if cm.group(1):
                entry = cur_name
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        im = _INSTR_RE.match(line)
        if not im:
            continue
        name, type_str, op, rest = im.groups()
        # split operands (inside parens) from attrs (after matching paren)
        depth, idx = 1, 0
        while idx < len(rest) and depth > 0:
            if rest[idx] == "(":
                depth += 1
            elif rest[idx] == ")":
                depth -= 1
            idx += 1
        opstr, attrs = rest[: idx - 1], rest[idx:]
        operands = re.findall(r"%([\w.\-]+)", opstr)
        cur.append(Instruction(
            name=name, shapes=_parse_shapes(type_str), op=op,
            operands=operands, attrs=attrs, raw=line.strip()))
    return comps, entry, num_partitions


def _expand_iota_groups(num_groups: int, group_size: int,
                        reshape_dims: list[int],
                        perm: list[int] | None) -> list[tuple[int, ...]]:
    n = int(np.prod(reshape_dims))
    arr = np.arange(n).reshape(reshape_dims)
    if perm:
        arr = arr.transpose(perm)
    arr = arr.reshape(num_groups, group_size)
    return [tuple(int(x) for x in row) for row in arr]


def parse_replica_groups(attrs: str, num_partitions: int
                         ) -> list[tuple[int, ...]] | None:
    """Handle explicit ``{{0,1},{2,3}}`` and iota ``[G,S]<=[dims]T(perm)``."""
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?",
                  attrs)
    if m:
        ng, gs = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        perm = [int(x) for x in m.group(4).split(",")] if m.group(4) else None
        return _expand_iota_groups(ng, gs, dims, perm)
    m = re.search(r"replica_groups=(\{\{.*?\}\}|\{\s*\})", attrs)
    if m:
        body = m.group(1)
        groups = re.findall(r"\{([\d,\s]+)\}", body)
        out = []
        for g in groups:
            ids = tuple(int(x) for x in g.replace(" ", "").split(",") if x)
            if ids:
                out.append(ids)
        if out:
            return out
        return [tuple(range(num_partitions))]
    return None


def _parse_source_target_pairs(attrs: str) -> list[tuple[int, int]] | None:
    m = re.search(r"source_target_pairs=\{(.*?)\}\}", attrs)
    if m:
        pairs = re.findall(r"\{(\d+),(\d+)\}", m.group(0))
        return [(int(a), int(b)) for a, b in pairs]
    return None


def _trip_count(cond_instrs: list[Instruction]) -> float:
    """Extract the loop trip count from a while condition computation.

    ``lax.scan``/``fori_loop`` lower to ``compare(iv, K), direction=LT`` with
    iv starting at 0 and stepping by 1, so the comparison constant IS the
    trip count.  Fall back to the largest integer constant in the body.
    """
    consts: dict[str, int] = {}
    for ins in cond_instrs:
        if ins.op == "constant":
            m = re.search(r"constant\((-?\d+)\)", ins.raw)
            if m:
                consts[ins.name] = int(m.group(1))
    for ins in cond_instrs:
        if ins.op == "compare" and "direction=LT" in ins.attrs:
            for o in ins.operands:
                if o in consts:
                    return float(max(consts[o], 1))
    if consts:
        return float(max(max(consts.values()), 1))
    return 1.0


def _dot_flops(ins: Instruction, symtab: dict) -> float:
    result_elems = 1.0
    for _, dims in ins.shapes:
        result_elems *= float(np.prod(dims)) if dims else 1.0
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.attrs)
    cdims = [int(x) for x in m.group(1).split(",") if x] if m else []
    k = 1.0
    if ins.operands:
        lhs = symtab.get(ins.operands[0])
        if lhs and lhs.shapes:
            _, ldims = lhs.shapes[0]
            for c in cdims:
                if c < len(ldims):
                    k *= ldims[c]
    return 2.0 * result_elems * k


def _conv_flops(ins: Instruction, symtab: dict) -> float:
    result_elems = 1.0
    for _, dims in ins.shapes:
        result_elems *= float(np.prod(dims)) if dims else 1.0
    k = 1.0
    if len(ins.operands) >= 2:
        rhs = symtab.get(ins.operands[1])
        if rhs and rhs.shapes:
            _, rdims = rhs.shapes[0]
            k = float(np.prod(rdims)) if rdims else 1.0
            # divide by output-feature dim: each output elem sees kernel/out_f
            m = re.search(r"dim_labels=[\w?]*_([\w?]*)->", ins.attrs)
            if m and "o" in m.group(1) and rdims:
                o_pos = m.group(1).index("o")
                if o_pos < len(rdims) and rdims[o_pos] > 0:
                    k /= rdims[o_pos]
            gm = re.search(r"feature_group_count=(\d+)", ins.attrs)
            if gm:
                k /= max(int(gm.group(1)), 1)
    return 2.0 * result_elems * k


def _fusion_slice_sizes(ins, comps) -> dict:
    """For a fusion op: {operand_index: bytes actually read} for operands
    whose in-fusion consumers are all slicing ops (dynamic-slice / slice /
    gather) — the fused kernel only touches the sliced window."""
    import re as _re
    m = _re.search(r"calls=%?([\w.\-]+)", ins.attrs)
    if not m or m.group(1) not in comps:
        return {}
    body = comps[m.group(1)]
    params = {}
    for i2 in body:
        if i2.op == "parameter":
            pm = _re.search(r"parameter\((\d+)\)", i2.raw)
            if pm:
                params[i2.name] = int(pm.group(1))
    out: dict = {}
    slicing = ("dynamic-slice", "slice", "gather")
    for pname, pidx in params.items():
        consumers = [i2 for i2 in body if pname in i2.operands]
        if consumers and all(c.op in slicing for c in consumers):
            out[pidx] = sum(_nbytes(c.shapes) for c in consumers)
    return out


def profile_hlo(hlo_text: str, fusion_model: bool = True) -> HloProfile:
    """Parse optimized HLO into per-device FLOPs / HBM bytes / collectives.

    ``fusion_model=True`` (default) applies the TPU-fusion byte model: pure
    elementwise/layout ops carry no HBM traffic of their own (see
    _ELEMENTWISE).  ``False`` charges every instruction — an upper bound
    that mirrors the CPU backend's actual buffer boundaries.
    """
    comps, entry, nparts = parse_computations(hlo_text)
    if entry is None:
        raise ValueError("no ENTRY computation found in HLO text")

    memo: dict[str, tuple] = {}

    def cost(comp_name: str):
        """-> (flops, bytes_accessed, [CollectiveOp]) for one execution."""
        if comp_name in memo:
            return memo[comp_name]
        instrs = comps.get(comp_name, [])
        symtab = {i.name: i for i in instrs}
        flops = 0.0
        nbytes = 0.0
        tags: dict = {}
        colls: list[CollectiveOp] = []

        def _tag_of(ins):
            m = re.search(r'op_name="([^"]*)"', ins.attrs)
            if not m:
                return None
            name = m.group(1)
            for tag, pats in _TAG_PATTERNS.items():
                if any(p in name for p in pats):
                    return tag
            return None
        for ins in instrs:
            op = ins.op
            base = op[:-6] if op.endswith("-start") else op
            if base in COLLECTIVE_KINDS:
                operand_bytes = 0.0
                for o in ins.operands:
                    d = symtab.get(o)
                    if d:
                        operand_bytes += _nbytes(d.shapes)
                if operand_bytes == 0.0:
                    # async-start result includes (operand, result, ...) tuple
                    operand_bytes = _nbytes(ins.shapes) / 2.0
                stp = _parse_source_target_pairs(ins.attrs) \
                    if base == "collective-permute" else None
                groups = parse_replica_groups(ins.attrs, nparts)
                if base == "collective-permute":
                    gsize = 2
                    groups = None
                else:
                    gsize = len(groups[0]) if groups else nparts
                colls.append(CollectiveOp(
                    kind=base, operand_bytes=operand_bytes, groups=groups,
                    group_size=gsize, multiplier=1.0,
                    source_target_pairs=stp))
                nbytes += operand_bytes + _nbytes(ins.shapes)
                continue
            if op.endswith("-done") or op.endswith("-update"):
                continue
            if op == "while":
                body = re.search(r"body=%?([\w.\-]+)", ins.attrs)
                cond = re.search(r"condition=%?([\w.\-]+)", ins.attrs)
                trips = _trip_count(comps.get(cond.group(1), [])) if cond else 1.0
                if body:
                    bf, bb, bc, bt = cost(body.group(1))
                    flops += bf * trips
                    nbytes += bb * trips
                    for t, v in bt.items():
                        tags[t] = tags.get(t, 0.0) + v * trips
                    for c in bc:
                        colls.append(dataclasses.replace(
                            c, multiplier=c.multiplier * trips))
                continue
            if op in ("fusion", "call", "custom-call", "map", "reduce",
                      "reduce-window", "sort", "scatter", "select-and-scatter",
                      "conditional", "async-start"):
                # expand nested computations (calls=/to_apply=/branches)
                for attr in ("calls", "to_apply"):
                    mm = re.search(attr + r"=%?([\w.\-]+)", ins.attrs)
                    if mm and mm.group(1) in comps:
                        cf, cb, cc, ct = cost(mm.group(1))
                        flops += cf
                        colls.extend(cc)
                        if op in ("call", "async-start"):
                            # plain calls execute their body ops; fusions
                            # melt them (boundary charged at call site)
                            nbytes += cb
                            for t, v in ct.items():
                                tags[t] = tags.get(t, 0.0) + v
                        # fusion HBM traffic is params+result, counted below
                if op == "conditional":
                    br = re.findall(r"%([\w.\-]+)", ins.attrs)
                    sub = [b for b in br if b in comps]
                    if sub:
                        costs = [cost(b) for b in sub]
                        flops += max(c[0] for c in costs)
                        nbytes += max(c[1] for c in costs)
            if op == "dot":
                flops += _dot_flops(ins, symtab)
            elif op == "convolution":
                flops += _conv_flops(ins, symtab)
            if op in _SKIP_BYTES:
                continue
            if fusion_model and op in _ELEMENTWISE:
                continue
            if op == "dynamic-slice":
                # reads only the slice (result), not the whole operand
                rb = _nbytes(ins.shapes)
                nbytes += 2 * rb
                t = _tag_of(ins)
                if t:
                    tags[t] = tags.get(t, 0.0) + 2 * rb
                continue
            if op == "dynamic-update-slice":
                # in-place on TPU (input/output alias): traffic is the
                # updated slice (read + write), not the whole buffer
                upd = symtab.get(ins.operands[1]) if len(ins.operands) > 1 \
                    else None
                ub = _nbytes(upd.shapes) if upd else 0.0
                nbytes += 2 * ub
                t = _tag_of(ins)
                if t:
                    tags[t] = tags.get(t, 0.0) + 2 * ub
                continue
            # HBM traffic model: operands read + result written, per op.
            # For fusions, an operand consumed only via (dynamic-)slice /
            # gather inside the fused computation is read at slice size,
            # not full size (scan bodies slice one layer of a stacked
            # weight/cache buffer per step).
            slice_sizes = _fusion_slice_sizes(ins, comps) \
                if ins.op == "fusion" else {}
            seen = set()
            op_bytes = 0.0
            for idx, o in enumerate(ins.operands):
                if o in seen:
                    continue
                seen.add(o)
                d = symtab.get(o)
                if d:
                    b = _nbytes(d.shapes)
                    if idx in slice_sizes:
                        b = min(b, slice_sizes[idx])
                    op_bytes += b
            op_bytes += _nbytes(ins.shapes)
            nbytes += op_bytes
            t = _tag_of(ins)
            if t:
                tags[t] = tags.get(t, 0.0) + op_bytes
        memo[comp_name] = (flops, nbytes, colls, tags)
        return memo[comp_name]

    flops, nbytes, colls, tags = cost(entry)
    raw = sum(c[0] for name, c in memo.items()) if memo else flops
    return HloProfile(flops=flops, bytes_accessed=nbytes, collectives=colls,
                      num_partitions=nparts, raw_flops=raw,
                      bytes_by_tag=tags)


# --------------------------------------------------------------------------
# comm graph extraction (profiler output -> guest graph for TOFA)
# --------------------------------------------------------------------------

def comm_graph_from_profile(profile: HloProfile,
                            n_devices: int | None = None) -> CommGraph:
    """Decompose every profiled collective into p2p phases -> G_v / G_m."""
    n = n_devices or profile.num_partitions
    g = CommGraph(n)
    for c in profile.collectives:
        rep = c.multiplier
        if c.kind == "collective-permute" and c.source_target_pairs:
            g.add_collective_permute(c.source_target_pairs, c.operand_bytes,
                                     repeats=rep)
            continue
        groups = c.groups or [tuple(range(n))]
        for grp in groups:
            grp = [d for d in grp if d < n]
            if len(grp) <= 1:
                continue
            if c.kind == "all-reduce":
                g.add_all_reduce(grp, c.operand_bytes, repeats=rep)
            elif c.kind == "all-gather":
                g.add_all_gather(grp, c.operand_bytes, repeats=rep)
            elif c.kind == "reduce-scatter":
                g.add_reduce_scatter(grp, c.operand_bytes, repeats=rep)
            elif c.kind == "all-to-all":
                g.add_all_to_all(grp, c.operand_bytes, repeats=rep)
            elif c.kind == "collective-broadcast":
                g.add_broadcast(grp, c.operand_bytes, repeats=rep)
    return g


def comm_graph_from_hlo(hlo_text: str, n_devices: int | None = None
                        ) -> CommGraph:
    return comm_graph_from_profile(profile_hlo(hlo_text), n_devices)


# --------------------------------------------------------------------------
# torch programs: one step read on fake tensors
# --------------------------------------------------------------------------

# functional collectives (``torch.distributed._functional_collectives``,
# the ops DTensor issues) -> canonical kind
_FUNCOL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "c10d_functional",
                      "_c10d_functional_autograd", "_dtensor")

# aten ops with no HBM traffic of their own: allocation, aliasing and
# bookkeeping (the HLO's _SKIP_BYTES), and the conversions and fills a
# fusing compiler melts into their neighbours (with every op tagged
# ``pointwise``: the HLO's _ELEMENTWISE under its fusion model)
_TORCH_SKIP_BYTES = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
    "resize_", "wait_tensor", "_local_scalar_dense", "device",
}
_TORCH_ELEMENTWISE = {
    "_to_copy", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "fill", "fill_",
    "zero_", "arange", "scalar_tensor", "tril", "triu",
}


@dataclasses.dataclass
class TorchProfile(HloProfile):
    """An :class:`HloProfile` of one step of a PyTorch program, with its
    memory: ``arg_bytes``, the storage of the step's arguments on one
    device (its local shards: parameters, optimizer state, caches, batch),
    and ``peak_bytes``, the largest sum of live local storages while the
    step ran, arguments included (the counterpart of XLA's argument +
    output - alias + temp); ``temp_bytes`` is the difference.  Views
    share their base's storage and count once."""

    arg_bytes: float = 0.0
    peak_bytes: float = 0.0

    @property
    def temp_bytes(self) -> float:
        return self.peak_bytes - self.arg_bytes


def _tensor_bytes(t) -> float:
    return float(t.numel() * t.element_size())


def _local_tensors(obj):
    """Every tensor reachable from ``obj`` (modules, mappings, sequences,
    named tuples), a DTensor as its local shard."""
    from torch import nn
    if isinstance(obj, nn.Module):
        yield from (_local(t) for t in (*obj.parameters(), *obj.buffers()))
    elif isinstance(obj, torch.Tensor):
        yield _local(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _local_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _local_tensors(v)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


class _GroupMap:
    """Process group name -> the replica groups over logical shard ids
    (positions in the row-major flattening of ``mesh.mesh``), every slice
    of the mesh along the dims the group spans, as the HLO's iota groups
    list them.  A rank sees only its own group: the dims are those whose
    slice through this rank's position holds the group's ranks."""

    def __init__(self, mesh):
        self.ranks = mesh.mesh.cpu().numpy()
        me = np.argwhere(self.ranks == torch.distributed.get_rank())
        if len(me) != 1:
            raise ValueError("this rank is not in the mesh")
        self.coord = tuple(int(c) for c in me[0])
        self.cache: dict = {}

    def groups(self, group_name: str) -> list:
        if group_name not in self.cache:
            self.cache[group_name] = self._groups(group_name)
        return self.cache[group_name]

    def _groups(self, group_name: str) -> list:
        import itertools

        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        members = set(dist.get_process_group_ranks(
            _resolve_process_group(group_name)))
        nd = self.ranks.ndim
        pos = np.arange(self.ranks.size).reshape(self.ranks.shape)
        for k in range(1, nd + 1):
            for dims in itertools.combinations(range(nd), k):
                idx = tuple(slice(None) if d in dims else self.coord[d]
                            for d in range(nd))
                if set(self.ranks[idx].ravel().tolist()) == members:
                    rest = [d for d in range(nd) if d not in dims]
                    size = int(np.prod([self.ranks.shape[d] for d in dims]))
                    arr = pos.transpose(*rest, *dims).reshape(-1, size)
                    return [tuple(int(x) for x in row) for row in arr]
        raise ValueError(f"process group {group_name!r} is no slice of the "
                         f"mesh {self.ranks.tolist()}")


def _op_name(func) -> str:
    return func._schema.name.split("::")[-1]


def _collective(func, args, kwargs, groups: _GroupMap):
    """A :class:`CollectiveOp` for a functional collective, else None."""
    name = _op_name(func)
    if func.namespace not in _FUNCOL_NAMESPACES or name not in _FUNCOL_KINDS:
        return None
    if groups is None:
        raise ValueError(f"{func} in a step profiled without a mesh")
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs or {})
    inp = bound.get("input", bound.get("inputs"))
    tensors = inp if isinstance(inp, (list, tuple)) else [inp]
    grps = groups.groups(bound["group_name"])
    return CollectiveOp(kind=_FUNCOL_KINDS[name],
                        operand_bytes=sum(_tensor_bytes(t) for t in tensors),
                        groups=grps, group_size=len(grps[0]),
                        multiplier=1.0)


def _charge(func) -> str:
    """How an operation's HBM bytes count under the HLO profiler's fusion
    model: ``"none"`` for aliasing and bookkeeping, pointwise operations,
    conversions and fills, ``"copy"`` for an
    in-place ``copy_`` (a write into a slice: the HLO's
    dynamic-update-slice, its source's size read and written),
    ``"collective"`` for a functional collective (operand and result),
    else ``"io"``: every input read once and every output written."""
    name = _op_name(func)
    if func.namespace in _FUNCOL_NAMESPACES and name in _FUNCOL_KINDS:
        return "collective"
    if name in _TORCH_SKIP_BYTES or func.is_view \
            or torch.Tag.pointwise in func.tags or name in _TORCH_ELEMENTWISE:
        return "none"
    return "copy" if name == "copy_" else "io"


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class _Recorder:
    """What one step dispatches, on one rank: collectives, FLOPs, bytes by
    tag and live storage."""

    def __init__(self, mesh):
        self.groups = None if mesh is None else _GroupMap(mesh)
        self.flops = 0.0
        self.nbytes = 0.0
        self.tags: dict = {}
        self.collectives: list = []
        self.live = 0.0
        self.peak = 0.0
        from torch.utils.weak import WeakIdKeyDictionary
        self.storages = WeakIdKeyDictionary()
        self.charges: dict = {}       # operation -> how its bytes count

    def hold(self, t) -> None:
        """Count ``t``'s storage as live until it is freed."""
        import weakref
        st = t.untyped_storage()
        if st in self.storages:
            return
        n = float(st.nbytes())
        self.storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: float) -> None:
        self.live -= n

    def alias(self, t, base) -> None:
        """Count ``t``, which the real operation returns as ``base``
        itself, as ``base``'s storage: once, and live while either is."""
        import weakref
        st, held = t.untyped_storage(), base.untyped_storage()
        if held not in self.storages:
            return self.hold(t)
        if st is not held and st not in self.storages:
            self.storages[st] = 0.0
            weakref.finalize(st, lambda keep: None, held)

    def record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        from repro_torch.kernels import PROFILE_TAG_KEY, PROFILE_TAGS
        charge = self.charges.get(func)
        if charge is None:
            charge = self.charges[func] = _charge(func)
        outs = _tensors(out)
        b = 0.0
        if charge == "collective":
            coll = _collective(func, args, kwargs, self.groups)
            self.collectives.append(coll)
            b = coll.operand_bytes + sum(_tensor_bytes(t) for t in outs)
        else:
            f = flop_registry.get(func._overloadpacket)
            if f is not None:
                self.flops += float(f(*args, **(kwargs or {}), out_val=out))
            if charge == "copy" and isinstance(args[1], torch.Tensor):
                b = 2.0 * _tensor_bytes(args[1])
            elif charge == "io":
                seen = set()
                for t in (*_tensors((args, kwargs or {})), *outs):
                    if id(t) not in seen:
                        seen.add(id(t))
                        b += _tensor_bytes(t)
        if b:
            self.nbytes += b
            tag = PROFILE_TAGS[-1] if PROFILE_TAGS else None
            if tag is None:
                node = torch._C._current_autograd_node()
                tag = None if node is None else node.metadata.get(
                    PROFILE_TAG_KEY)
            if tag is not None:
                self.tags[tag] = self.tags.get(tag, 0.0) + b
        if func.namespace in _FUNCOL_NAMESPACES \
                and _op_name(func) == "wait_tensor":
            # the real op returns its input; a fake one makes new storage
            self.alias(outs[0], args[0])
            return
        for t in outs:
            self.hold(t)


def fake_mode():
    """A ``FakeTensorMode`` that :func:`profile_torch` can record a step
    in: build the program's model, state and inputs under it (``with
    fake_mode() as mode:``), then profile the step.  Nothing is
    allocated; every tensor made under it is a fake one (shape, dtype,
    device) and every operation only computes its output's metadata."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    class RecordingFakeMode(FakeTensorMode):
        recorder = None
        depth = 0        # local operations being dispatched now

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.recorder is None or any(issubclass(t, DTensor)
                                            for t in types):
                return super().__torch_dispatch__(func, types, args, kwargs)
            # a decomposition's operations, dispatched inside their
            # operation's, are that operation's work: recorded once
            self.depth += 1
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self.depth -= 1
            if self.depth == 0 and out is not NotImplemented:
                self.recorder.record(func, args, kwargs, out)
            return out

    return RecordingFakeMode()


@contextlib.contextmanager
def _resharding_all_to_all():
    """DTensor moves a shard to another tensor dim with an all-to-all on
    an nccl group, but on a CPU mesh it falls back to an all-gather and a
    chunk (gloo has no all-to-all).  Within this context a CPU mesh takes
    the nccl route too (the mesh reads as a CUDA one for that call only):
    the trace then reads the collective the step runs on the card."""
    from torch.distributed.tensor import placement_types
    run = placement_types.shard_dim_alltoall

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return run(input, gather_dim, shard_dim, mesh, mesh_dim)
        # a property over _device_type in some releases, a field in others
        field = ("_device_type" if isinstance(
            getattr(type(mesh), "device_type", None), property)
            else "device_type")
        setattr(mesh, field, "cuda")
        try:
            return run(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            setattr(mesh, field, "cpu")

    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = run


@contextlib.contextmanager
def _dtensor_planning_unrecorded(mode):
    """DTensor's planning, kept out of the step it plans:

    * deriving an operation's global output shape, it runs the operation
      on fake tensors of the global shape, in the active fake mode, once
      per operation and input layout: nothing is recorded meanwhile;
    * a strided shard's offsets it computes from a ``torch.arange`` read
      back with ``tolist()``, which a fake tensor cannot do: those index
      tensors are made as real ones (a few integers)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    prop = DTensor._op_dispatcher.sharding_propagator
    run = prop._propagate_tensor_meta_non_cached
    offsets = getattr(_StridedShard, "local_shard_size_and_offset", None)

    def quiet(op_schema):
        rec, mode.recorder = mode.recorder, None
        try:
            return run(op_schema)
        finally:
            mode.recorder = rec

    def real_offsets(*args, **kwargs):
        with unset_fake_temporarily():
            return offsets(*args, **kwargs)

    prop._propagate_tensor_meta_non_cached = quiet
    if offsets is not None:
        _StridedShard.local_shard_size_and_offset = real_offsets
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached
        if offsets is not None:
            _StridedShard.local_shard_size_and_offset = offsets


def profile_torch(fn, *args, mesh=None,
                  reshard_all_to_all: bool = True) -> TorchProfile:
    """Run ``fn(*args)`` once, under the fake mode its tensors were made
    in (:func:`fake_mode`), and read the step as :func:`profile_hlo`
    reads a compiled one, per device (this rank's local shards):

    * every functional collective (``c10d_functional`` /
      ``_c10d_functional``: all-reduce, all-gather, reduce-scatter,
      all-to-all, broadcast) with its per-rank operand bytes, its process
      group mapped to the mesh dims it spans and expanded to every replica
      group of ``mesh`` along them (logical shard ids: positions in
      ``mesh.mesh``); ``num_partitions`` is ``mesh.size()`` (1 for a step
      without a mesh, which may run no collective);
    * FLOPs by ``torch.utils.flop_counter``'s formulas on the local
      operations (eager tracing runs every layer and every recompute:
      no loop correction);
    * HBM bytes: each local non-view operation's inputs and outputs, with
      the fusion model of :func:`profile_hlo` (pointwise operations,
      conversions and fills add no traffic of their own);
      the bytes of the plain flash-attention and SSD versions, forward
      and backward, go to ``bytes_by_tag["flash"]`` / ``["ssd"]``;
    * memory: see :class:`TorchProfile`.

    Operations on DTensors are read through the local operations they
    run.  ``reshard_all_to_all`` reads a CPU mesh's step as it runs on an
    nccl group, where DTensor moves a shard between tensor dims with an
    all-to-all (gloo's fallback is an all-gather and a chunk)."""
    from torch._guards import detect_fake_mode

    from repro_torch import kernels
    mode = detect_fake_mode(tuple(_local_tensors(args)))
    if mode is None or not hasattr(mode, "recorder"):
        raise TypeError("profile_torch reads a step on fake tensors: make "
                        "its model, state and inputs under fake_mode()")
    rec = _Recorder(mesh)
    for t in _local_tensors(args):
        rec.hold(t)
    arg_bytes = rec.live
    mode.recorder, kernels.PROFILING[0] = rec, True
    try:
        with mode, _dtensor_planning_unrecorded(mode), \
                (_resharding_all_to_all() if reshard_all_to_all
                 else contextlib.nullcontext()):
            fn(*args)
    finally:
        mode.recorder, kernels.PROFILING[0] = None, False
    return TorchProfile(flops=rec.flops, bytes_accessed=rec.nbytes,
                        collectives=rec.collectives,
                        num_partitions=1 if mesh is None
                        else int(mesh.size()), raw_flops=rec.flops,
                        bytes_by_tag=rec.tags, arg_bytes=arg_bytes,
                        peak_bytes=rec.peak)


def record_collectives(fn, *args, mesh) -> list:
    """The collectives of ``fn(*args)`` run for real (on the process group
    of ``mesh``, no fake tensors), as :func:`profile_torch` lists them:
    the same step on fake tensors must give the same list."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    groups, found = _GroupMap(mesh), []

    class Listen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                # DTensor runs first and issues its collectives as local
                # operations, which come back through this mode
                return NotImplemented
            c = _collective(func, args, kwargs, groups)
            if c is not None:
                found.append(c)
            return func(*args, **(kwargs or {}))

    with Listen():
        fn(*args)
    return found
