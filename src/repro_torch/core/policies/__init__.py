"""Pluggable placement policies.

Importing this package registers the five seed policies — ``linear``,
``random``, ``greedy``, ``topo``, ``tofa`` — in that order.  Third-party
policies register the same way:

    from repro_torch.core.policies import PolicyOutput, register_policy

    @register_policy("mine")
    class MinePolicy:
        fault_aware = True
        def place(self, ctx):
            return PolicyOutput(...)
"""
from repro_torch.core.policies.base import (
    DuplicatePolicyError, PlacementPolicy, PolicyContext, PolicyError,
    PolicyOutput, UnknownPolicyError, available_policies, get_policy,
    register_policy, unregister_policy)
# import order == registration order == legacy POLICIES tuple order
from repro_torch.core.policies import baselines as _baselines  # noqa: E402,F401
from repro_torch.core.policies import scotch as _scotch        # noqa: E402,F401
from repro_torch.core.policies import tofa as _tofa            # noqa: E402,F401
from repro_torch.core.policies.tofa import FAULT_BLOCK

__all__ = [
    "DuplicatePolicyError", "PlacementPolicy", "PolicyContext", "PolicyError",
    "PolicyOutput", "UnknownPolicyError", "available_policies", "get_policy",
    "register_policy", "unregister_policy", "FAULT_BLOCK",
]
