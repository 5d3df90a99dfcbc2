"""Baseline placement policies of the paper's Section 5.1.

``linear`` (default-slurm), ``random``, and ``greedy`` — all fault-blind:
they see only the availability mask (Slurm never schedules onto
DOWN/DRAINED nodes, independent of fault-awareness) and the healthy hop
metric.
"""
from __future__ import annotations

from .. import mapping
from .base import PolicyContext, PolicyOutput, register_policy


@register_policy("linear")
class LinearPolicy:
    """default-slurm: iterate available nodes sequentially."""

    fault_aware = False

    def place(self, ctx: PolicyContext) -> PolicyOutput:
        return PolicyOutput(mapping.linear_placement(ctx.n_procs, ctx.available))


@register_policy("random")
class RandomPolicy:
    """Uniform random draw without replacement from the available nodes."""

    fault_aware = False

    def place(self, ctx: PolicyContext) -> PolicyOutput:
        return PolicyOutput(
            mapping.random_placement(ctx.n_procs, ctx.available, ctx.rng))


@register_policy("greedy")
class GreedyPolicy:
    """Heaviest-traffic pairs placed as close as possible (paper baseline)."""

    fault_aware = False

    def place(self, ctx: PolicyContext) -> PolicyOutput:
        return PolicyOutput(
            mapping.greedy_placement(ctx.G_w, ctx.available, ctx.hops))
