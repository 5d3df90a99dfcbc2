"""``topo`` — topology-aware but fault-blind mapping (paper Section 5.1).

The Scotch-analogue run of the paper's comparison: dual recursive
bipartitioning onto the healthy hop metric, ignoring ``p_f`` entirely.
"""
from __future__ import annotations

import numpy as np

from .. import mapping
from .base import PolicyContext, PolicyOutput, register_policy


@register_policy("topo")
class ScotchPolicy:
    """Fault-blind Scotch mapping: window + compact-ball candidates."""

    fault_aware = False

    def place(self, ctx: PolicyContext) -> PolicyOutput:
        n, avail = ctx.n_procs, ctx.available
        subsets = [avail[:n]]
        if n < len(avail) and not mapping.is_lazy(ctx.hops):
            # the restricted-matrix ball needs a dense metric; above the
            # lazy threshold the sequential window candidate stands alone
            Wa = ctx.hops[np.ix_(avail, avail)]
            subsets.append(avail[mapping.select_nodes(Wa, n)])
        placement = mapping.best_map(ctx.G_w, subsets, ctx.coords, ctx.hops, ctx.rng)
        return PolicyOutput(placement)
