"""Communication graph G: the paper's MPI-profiler output, adapted to SPMD.

The paper's profiling tool intercepts MPI primitives and accumulates two
N x N matrices: ``G_v`` (bytes exchanged per rank pair) and ``G_m`` (message
count per rank pair).  Collectives are decomposed into the point-to-point
phases of the algorithm each collective actually uses, so per-pair traffic is
accurate (Section 3).

Here the same abstraction profiles an SPMD JAX program: each *shard* (logical
device) is a rank, and each XLA collective is decomposed over its replica
groups into point-to-point phases:

* ``ring``                all-reduce / all-gather / reduce-scatter on TPU ICI
* ``recursive_doubling``  small all-reduces (latency-bound regime)
* ``pairwise``            all-to-all (MoE dispatch/combine)
* ``binomial_tree``       broadcast
* ``direct``              collective-permute (explicit src->dst pairs)

Byte conventions (per device, matching XLA operand semantics):
  all_reduce(S)       operand S is the full buffer; ring sends 2*(g-1)/g*S
  all_gather(S)       operand S is the local shard; ring sends (g-1)*S
  reduce_scatter(S)   operand S is the full buffer; ring sends (g-1)/g*S
  all_to_all(S)       operand S is the local buffer; sends (g-1)/g*S total
  collective_permute  operand S sent once per (src, dst) pair

``G_v``/``G_m`` are symmetric: entry (i, j) is total traffic between i and j
in both directions, exactly as in the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass
class CommGraph:
    """The guest graph G = (V_G, E_G) with byte and message weights."""

    n: int
    G_v: np.ndarray = None  # bytes
    G_m: np.ndarray = None  # messages

    def __post_init__(self):
        if self.G_v is None:
            self.G_v = np.zeros((self.n, self.n), dtype=np.float64)
        if self.G_m is None:
            self.G_m = np.zeros((self.n, self.n), dtype=np.float64)
        assert self.G_v.shape == (self.n, self.n)
        assert self.G_m.shape == (self.n, self.n)

    # ------------------------------------------------------------------ p2p
    def add_p2p(self, i: int, j: int, nbytes: float, nmsgs: float = 1.0) -> None:
        """Record traffic between ranks i and j (symmetric accumulation)."""
        if i == j:
            return
        self.G_v[i, j] += nbytes
        self.G_v[j, i] += nbytes
        self.G_m[i, j] += nmsgs
        self.G_m[j, i] += nmsgs

    def _scatter_pairs(
        self, src: np.ndarray, dst: np.ndarray, nbytes: float, nmsgs: float
    ) -> None:
        """Vectorized symmetric accumulation of many (src, dst) pairs.

        ``np.add.at`` handles repeated pairs (e.g. the two directed ring
        edges of a 2-rank group) by accumulating, exactly like sequential
        ``add_p2p`` calls; self-pairs are dropped to match its i == j guard.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst
        if not keep.all():
            src, dst = src[keep], dst[keep]
        if src.size == 0:
            return
        rows = np.concatenate([src, dst])
        cols = np.concatenate([dst, src])
        np.add.at(self.G_v, (rows, cols), nbytes)
        np.add.at(self.G_m, (rows, cols), nmsgs)

    # ----------------------------------------------------------- collectives
    def add_all_reduce(
        self, ranks: Sequence[int], nbytes: float,
        algorithm: str = "ring", repeats: float = 1.0,
    ) -> None:
        g = len(ranks)
        if g <= 1:
            return
        r = np.asarray(ranks, dtype=np.int64)
        if algorithm == "ring":
            # reduce-scatter phase + all-gather phase: each rank sends
            # 2*(g-1)/g*S to its ring successor over 2*(g-1) messages.
            per_pair = 2.0 * (g - 1) / g * nbytes
            self._scatter_pairs(r, np.roll(r, -1),
                                per_pair * repeats, 2 * (g - 1) * repeats)
        elif algorithm == "recursive_doubling":
            idx = np.arange(g)
            k = 1
            while k < g:
                peer = idx ^ k
                m = (peer < g) & (idx < peer)
                self._scatter_pairs(r[idx[m]], r[peer[m]],
                                    nbytes * repeats, repeats)
                k <<= 1
        else:
            raise ValueError(f"unknown all-reduce algorithm {algorithm!r}")

    def add_all_gather(
        self, ranks: Sequence[int], shard_bytes: float, repeats: float = 1.0
    ) -> None:
        g = len(ranks)
        if g <= 1:
            return
        r = np.asarray(ranks, dtype=np.int64)
        per_pair = (g - 1) * shard_bytes
        self._scatter_pairs(r, np.roll(r, -1),
                            per_pair * repeats, (g - 1) * repeats)

    def add_reduce_scatter(
        self, ranks: Sequence[int], full_bytes: float, repeats: float = 1.0
    ) -> None:
        g = len(ranks)
        if g <= 1:
            return
        r = np.asarray(ranks, dtype=np.int64)
        per_pair = (g - 1) / g * full_bytes
        self._scatter_pairs(r, np.roll(r, -1),
                            per_pair * repeats, (g - 1) * repeats)

    def add_all_to_all(
        self, ranks: Sequence[int], local_bytes: float, repeats: float = 1.0
    ) -> None:
        g = len(ranks)
        if g <= 1:
            return
        r = np.asarray(ranks, dtype=np.int64)
        chunk = local_bytes / g
        ii, jj = np.triu_indices(g, 1)
        self._scatter_pairs(r[ii], r[jj], 2 * chunk * repeats, 2 * repeats)

    def add_broadcast(
        self, ranks: Sequence[int], nbytes: float, root: int = 0,
        repeats: float = 1.0,
    ) -> None:
        """Binomial-tree broadcast rooted at ``ranks[root]``."""
        g = len(ranks)
        if g <= 1:
            return
        r = np.asarray(ranks, dtype=np.int64)
        order = np.arange(g)
        order[0], order[root] = order[root], order[0]
        k = 1
        while k < g:
            idx = np.arange(min(k, g - k))
            peer = idx + k
            self._scatter_pairs(r[order[idx]], r[order[peer]],
                                nbytes * repeats, repeats)
            k <<= 1

    def add_collective_permute(
        self, pairs: Iterable[tuple[int, int]], nbytes: float,
        repeats: float = 1.0,
    ) -> None:
        pairs = np.asarray(list(pairs), dtype=np.int64)
        if pairs.size == 0:
            return
        self._scatter_pairs(pairs[:, 0], pairs[:, 1],
                            nbytes * repeats, repeats)

    # -------------------------------------------------------------- algebra
    def merged(self, other: "CommGraph") -> "CommGraph":
        assert self.n == other.n
        return CommGraph(self.n, self.G_v + other.G_v, self.G_m + other.G_m)

    def scaled(self, factor: float) -> "CommGraph":
        return CommGraph(self.n, self.G_v * factor, self.G_m * factor)

    def total_bytes(self) -> float:
        return float(self.G_v.sum() / 2.0)

    def weights(self, metric: str = "volume") -> np.ndarray:
        """Edge-weight matrix used as guest graph: 'volume' or 'messages'.

        The paper (Section 3, citing [5]) notes the choice is application
        dependent and evaluates with *volume*; both are exposed.
        """
        if metric == "volume":
            return self.G_v
        if metric == "messages":
            return self.G_m
        raise ValueError(f"unknown metric {metric!r}")

    # -------------------------------------------------------------- heatmap
    def heatmap(self, width: int = 64, metric: str = "volume") -> str:
        """ASCII traffic heatmap (the paper's Fig. 1 analogue).

        Darker glyph == more traffic for that rank pair; supports visual
        inspection of pattern regularity.
        """
        m = self.weights(metric)
        n = self.n
        bins = min(width, n)
        idx = (np.arange(n) * bins // n)
        agg = np.zeros((bins, bins))
        # bin only the nonzero entries — the dense form materialised two
        # n x n index arrays just to scatter a (typically sparse) matrix
        i, j = np.nonzero(m)
        np.add.at(agg, (idx[i], idx[j]), m[i, j])
        shades = " .:-=+*#%@"
        mx = agg.max()
        if mx <= 0:
            return "\n".join(" " * bins for _ in range(bins))
        lvl = np.sqrt(agg / mx)  # sqrt for dynamic range, like a gamma curve
        rows = []
        for r in range(bins):
            rows.append("".join(shades[min(int(v * (len(shades) - 1) + 0.5),
                                           len(shades) - 1)] for v in lvl[r]))
        return "\n".join(rows)

    def regularity(self) -> float:
        """Fraction of traffic within +/- 10% of N of the main diagonal.

        LAMMPS-like banded patterns score near 1.0; NPB-DT-like irregular
        patterns score low.  Used by tests and the workload generator.
        """
        n = self.n
        band = max(1, int(0.1 * n))
        i, j = np.nonzero(self.G_v)
        if i.size == 0:
            return 1.0
        d = np.abs(i - j)
        w = self.G_v[i, j]
        return float(w[d <= band].sum() / w.sum())


def _ring_pairs(ranks: Sequence[int]) -> list[tuple[int, int]]:
    g = len(ranks)
    return [(ranks[i], ranks[(i + 1) % g]) for i in range(g)]
