"""Synthetic communication workloads — the paper's benchmark applications.

The paper evaluates with LAMMPS (regular, banded pattern: halo exchange from
spatial decomposition + global collectives for thermo output) and NPB-DT
class C (irregular: traffic flows along a randomized task DAG between
source, intermediate and sink ranks, nothing on the main diagonal).  These
generators reproduce those *patterns* (cf. the paper's Fig. 1 heatmaps) so
placement policies face the same regular-vs-irregular contrast, plus a few
classic kernels used by the wider literature.

Every generator also reports per-rank compute work (flop counts) so the
cluster simulator can model the communication/computation ratio.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.comm_graph import CommGraph


@dataclasses.dataclass
class Workload:
    """A job's profile: communication graph + compute + phase structure."""

    name: str
    comm: CommGraph
    flops_per_rank: float          # per communication round
    rounds: int                    # communication rounds per run
    pattern: str                   # 'regular' | 'irregular' | ...

    @property
    def n_ranks(self) -> int:
        return self.comm.n


def _grid3(n: int) -> tuple[int, int, int]:
    """Factor n into the most cubic (nx, ny, nz) grid, nx <= ny <= nz."""
    best = (1, 1, n)
    for a in range(1, int(round(n ** (1 / 3))) + 2):
        if n % a:
            continue
        m = n // a
        for b in range(a, int(m ** 0.5) + 2):
            if m % b:
                continue
            c = m // b
            if a * b * c == n and c >= b:
                if max(a, b, c) - min(a, b, c) < max(best) - min(best):
                    best = (a, b, c)
    return best


def lammps_like(
    n_ranks: int = 64,
    *,
    halo_bytes: float = 512e3,
    collective_bytes: float = 128e3,
    rounds: int = 100,
    flops_per_rank: float = 25e6,
) -> Workload:
    """LAMMPS rhodopsin-style profile: halo exchange of a periodic 3D
    spatial decomposition (rank grid nx x ny x nz, neighbours at rank
    strides 1, nz, ny*nz) + global all-reduces (thermo output).

    This is the multi-band regular heatmap of the paper's Fig. 1a: traffic
    concentrates on a few fixed diagonals.  A topology mapper can fold the
    3D rank grid isomorphically onto a 3D torus block (every halo 1 hop) —
    exactly the structure LAMMPS exposes in the paper's evaluation.  Byte
    arguments are per communication round."""
    nx, ny, nz = _grid3(n_ranks)
    g = CommGraph(n_ranks)

    def rid(x, y, z):
        return (x * ny + y) * nz + z

    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                i = rid(x, y, z)
                for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    if (dx and nx < 2) or (dy and ny < 2) or (dz and nz < 2):
                        continue
                    j = rid((x + dx) % nx, (y + dy) % ny, (z + dz) % nz)
                    if i != j:
                        g.add_p2p(i, j, rounds * halo_bytes, rounds)
    g.add_all_reduce(list(range(n_ranks)), collective_bytes, repeats=rounds / 10)
    return Workload("lammps", g, flops_per_rank, rounds, "regular")


def npb_dt_like(
    n_ranks: int = 85,
    *,
    msg_bytes: float = 640e3,
    seed: int = 7,
    rounds: int = 20,
    flops_per_rank: float = 30e6,
) -> Workload:
    """NPB-DT class C-style profile: a randomized task DAG (sources ->
    intermediate shuffle layers -> sinks).  DT class C uses 85 ranks; the
    shuffle edges put traffic far off the main diagonal (paper Fig. 1b)."""
    rng = np.random.default_rng(seed)
    g = CommGraph(n_ranks)
    perm = rng.permutation(n_ranks)
    n_src = max(2, n_ranks // 4)
    n_sink = max(2, n_ranks // 4)
    src = perm[:n_src]
    sink = perm[n_src:n_src + n_sink]
    mid = perm[n_src + n_sink:]
    # each source feeds 2 random intermediates, each intermediate feeds 2
    # others or sinks — a quad-tree-ish data-flow like DT's graphs
    for s in src:
        pool = mid if len(mid) else sink
        k = min(2, len(pool))
        for t in rng.choice(pool, size=k, replace=False):
            g.add_p2p(int(s), int(t), rounds * msg_bytes, rounds)
    for m in mid:
        k = min(2, len(sink))
        for t in rng.choice(sink, size=k, replace=False):
            g.add_p2p(int(m), int(t), rounds * msg_bytes * 2, rounds)
    return Workload("npb_dt", g, flops_per_rank, rounds, "irregular")


def halo3d(
    dims: tuple[int, int, int] = (4, 4, 4),
    *,
    face_bytes: float = 128e3,
    rounds: int = 100,
    flops_per_rank: float = 40e6,
) -> Workload:
    """3D nearest-neighbour halo exchange on a rank grid (stencil codes)."""
    nx, ny, nz = dims
    n = nx * ny * nz
    g = CommGraph(n)

    def rid(x, y, z):
        return (x * ny + y) * nz + z

    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                i = rid(x, y, z)
                for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    j = rid((x + dx) % nx, (y + dy) % ny, (z + dz) % nz)
                    if i != j:
                        g.add_p2p(i, j, face_bytes, rounds)
    return Workload("halo3d", g, flops_per_rank, rounds, "regular")


def alltoall_heavy(
    n_ranks: int = 64, *, local_bytes: float = 1e6, rounds: int = 50,
    flops_per_rank: float = 10e6,
) -> Workload:
    """FFT/transpose-style all-to-all — placement-insensitive worst case."""
    g = CommGraph(n_ranks)
    g.add_all_to_all(list(range(n_ranks)), local_bytes, repeats=rounds)
    return Workload("alltoall", g, flops_per_rank, rounds, "uniform")


def allreduce_heavy(
    n_ranks: int = 64, *, nbytes: float = 4e6, rounds: int = 100,
    flops_per_rank: float = 100e6,
) -> Workload:
    """Data-parallel training style: one big ring all-reduce per round."""
    g = CommGraph(n_ranks)
    g.add_all_reduce(list(range(n_ranks)), nbytes, repeats=rounds)
    return Workload("allreduce", g, flops_per_rank, rounds, "ring")


WORKLOADS = {
    "lammps": lammps_like,
    "npb_dt": npb_dt_like,
    "halo3d": halo3d,
    "alltoall": alltoall_heavy,
    "allreduce": allreduce_heavy,
}


def get_workload(name: str, **kw) -> Workload:
    return WORKLOADS[name](**kw)
