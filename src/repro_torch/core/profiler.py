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

The port keeps this parser as it is: it reads HLO text (from any XLA
program), and reading the collectives of a PyTorch program is not done
yet.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

import numpy as np

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
