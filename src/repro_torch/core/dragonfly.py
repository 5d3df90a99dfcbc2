"""Dragonfly host topology — the high-radix group/global-link fabric.

A dragonfly (Kim et al., ISCA 2008) arranges routers into ``g`` groups of
``a`` routers each; every router serves ``p`` hosts and owns ``h`` global
links.  Routers within a group are all-to-all connected; each ordered pair
of groups is joined by exactly one global link whose endpoints follow the
standard consecutive assignment (group ``i``'s global-link slot ``m``
— slots enumerated router-major — lands on the ``m``-th *other* group).
The balanced configuration is ``a = 2p = 2h`` with ``g = a*h + 1`` groups;
smaller ``g`` is allowed as long as every pair of groups still has a
dedicated slot (``g - 1 <= a*h``).

Compute nodes are the hosts; switches appear only in the distance model.
Counting switch-level link traversals (as :class:`~repro_torch.core.fattree.
FatTreeTopology` does):

    same host                              0 hops
    same router                            2 hops  (host-router-host)
    same group, different router           3 hops  (host-r-r-host)
    different groups                       3 + [src detour] + [dst detour]
                                           in {3, 4, 5}: one local hop on
                                           either side iff the endpoint's
                                           router is not the gateway owning
                                           that group pair's global link

Host ids are ordered (group, router, host), so *consecutive ids are
maximally co-located* — the property TOFA's consecutive-healthy-window
search and the resource-manager ordering assume, same as the fat-tree.

Fault weighting follows Eq. (1) in **endpoint form**: dragonflies are
multi-path fabrics (Valiant / adaptive routing detours around interior
failures), so only a faulty compute node that is itself a job endpoint
penalises a path — identical semantics to the fat-tree model.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import FAULT_PENALTY


@dataclasses.dataclass(frozen=True)
class DragonflyTopology:
    """Dragonfly of ``g`` groups x ``a`` routers x ``p`` hosts.

    ``p``  hosts per router, ``a`` routers per group, ``h`` global links
    per router, ``g`` groups (default the balanced maximum ``a*h + 1``).
    """

    p: int = 2
    a: int = 4
    h: int = 2
    g: int | None = None

    def __post_init__(self):
        if min(self.p, self.a, self.h) < 1:
            raise ValueError(
                f"dragonfly needs p, a, h >= 1, got ({self.p}, {self.a}, "
                f"{self.h})")
        g = self.a * self.h + 1 if self.g is None else self.g
        if g < 2:
            raise ValueError(f"dragonfly needs >= 2 groups, got {g}")
        if g - 1 > self.a * self.h:
            raise ValueError(
                f"g={g} groups need {g - 1} global-link slots per group "
                f"but a*h={self.a * self.h}; increase a or h")
        object.__setattr__(self, "g", g)

    # ------------------------------------------------------------------ basics
    @property
    def hosts_per_group(self) -> int:
        return self.a * self.p

    @property
    def n_groups(self) -> int:
        return self.g

    @property
    def n_nodes(self) -> int:
        return self.g * self.hosts_per_group

    def coords(self, node: int) -> tuple[int, int, int]:
        """Host id -> (group, router, host slot)."""
        grp, rest = divmod(node, self.hosts_per_group)
        router, host = divmod(rest, self.p)
        return (grp, router, host)

    def coords_array(self) -> np.ndarray:
        """(n_nodes, 3) (group, router, host) coordinates, id-ordered."""
        ids = np.arange(self.n_nodes)
        grp, rest = np.divmod(ids, self.hosts_per_group)
        router, host = np.divmod(rest, self.p)
        return np.stack([grp, router, host], axis=1)

    # ----------------------------------------------------------------- gateway
    def gateway_router(self, src_group: int, dst_group: int) -> int:
        """Router of ``src_group`` owning the global link to ``dst_group``.

        Slot ``m`` (the rank of ``dst_group`` among the other groups) lives
        on router ``m // h`` — the consecutive assignment, deterministic
        and consistent for both directions of a group pair.
        """
        if src_group == dst_group:
            raise ValueError("no global link within a group")
        m = dst_group - (dst_group > src_group)
        return m // self.h

    # --------------------------------------------------------------- distances
    def hop_matrix(self) -> np.ndarray:
        """(n, n) switch-level hop distances in {0, 2, 3, 4, 5}.

        Memoised on first use so topology construction stays O(1) and
        repeat callers share one dense matrix.
        """
        cached = self.__dict__.get("_hop_matrix")
        if cached is not None:
            return cached
        c = self.coords_array()
        grp, router = c[:, 0], c[:, 1]
        same_grp = grp[:, None] == grp[None, :]
        same_router = same_grp & (router[:, None] == router[None, :])
        # gateway detours for inter-group pairs: src side needs a local
        # hop iff its router does not own the slot toward the dst group
        # (and symmetrically on the dst side)
        dst_rank = grp[None, :] - (grp[None, :] > grp[:, None])  # m per pair
        src_rank = grp[:, None] - (grp[:, None] > grp[None, :])
        src_gw = dst_rank // self.h     # gateway router in the src group
        dst_gw = src_rank // self.h     # gateway router in the dst group
        hops = (3.0
                + (router[:, None] != src_gw)
                + (router[None, :] != dst_gw))
        hops[same_grp] = 3.0
        hops[same_router] = 2.0
        np.fill_diagonal(hops, 0.0)
        object.__setattr__(self, "_hop_matrix", hops)
        return hops

    def hierarchy_groups(self, target_groups: int = 64) -> np.ndarray:
        """(n,) group ids for hierarchical mapping.

        The dragonfly group is the natural "rack" (one electrical/global
        domain); when the caller wants finer granularity than ``g``
        groups, fall back to one group per router.
        """
        c = self.coords_array()
        if target_groups <= self.g:
            return c[:, 0].astype(np.int64)
        return (c[:, 0] * self.a + c[:, 1]).astype(np.int64)

    def weight_matrix(
        self,
        p_f: np.ndarray | None = None,
        c: float = 1.0,
        straggler: np.ndarray | None = None,
    ) -> np.ndarray:
        """Eq. (1) path weights in endpoint form.

        A path's only compute-node contacts are its two endpoints, so the
        weight is ``c * hops`` plus ``c * 100`` per faulty endpoint and
        ``c * s`` per straggling endpoint (slowdown factor ``s``) —
        identical semantics to the fat-tree model.
        """
        n = self.n_nodes
        w = c * self.hop_matrix()
        penalty = np.zeros(n)
        if p_f is not None:
            penalty += c * FAULT_PENALTY * (np.asarray(p_f, np.float64) > 0)
        if straggler is not None:
            penalty += c * np.asarray(straggler, dtype=np.float64)
        if (penalty > 0).any():
            extra = penalty[:, None] + penalty[None, :]
            np.fill_diagonal(extra, 0.0)
            w = w + extra
        return w

    def weight_matrix_update(
        self,
        W_prev: np.ndarray,
        changed,
        p_f: np.ndarray | None = None,
        c: float = 1.0,
        straggler: np.ndarray | None = None,
    ) -> np.ndarray:
        """Row-wise delta refresh of :meth:`weight_matrix`.

        Endpoint form: a node's health only enters through its own
        penalty term, so a change at node x invalidates exactly row x and
        column x (bit-identical to a full derivation).
        """
        changed = np.atleast_1d(np.asarray(changed, dtype=np.int64))
        if changed.size == 0:
            return W_prev
        n = self.n_nodes
        penalty = np.zeros(n)
        if p_f is not None:
            penalty += c * FAULT_PENALTY * (np.asarray(p_f, np.float64) > 0)
        if straggler is not None:
            penalty += c * np.asarray(straggler, dtype=np.float64)
        extra = penalty[:, None] + penalty[None, :]
        np.fill_diagonal(extra, 0.0)
        ref = c * self.hop_matrix() + extra
        W = W_prev.copy()
        W[changed, :] = ref[changed, :]
        W[:, changed] = ref[:, changed]
        return W
