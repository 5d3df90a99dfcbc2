"""Policy registry + protocol for the :class:`~repro_torch.core.engine.PlacementEngine`.

A placement *policy* is a strategy object that maps a prepared
:class:`PolicyContext` (guest graph, host matrices, health, availability,
RNG) to a placement array.  Policies self-register by name with
``@register_policy("name")`` and are looked up with :func:`get_policy`, so
string dispatch lives in the registry — never in call sites.  This is the
extension point that lets Scotch-style mappers, grid/torus-specialised
mappers, and fault-aware mappers coexist behind one interface.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Optional, Protocol, runtime_checkable

import numpy as np


class PolicyError(ValueError):
    """Base class for registry errors (a ``ValueError`` so legacy callers
    that caught the old string-dispatch error keep working)."""


class UnknownPolicyError(PolicyError):
    """Requested policy name is not registered."""


class DuplicatePolicyError(PolicyError):
    """A policy with this name is already registered."""


@dataclasses.dataclass
class PolicyContext:
    """Inputs prepared (and cached) by the engine for one placement call.

    ``weights`` — the Eq. 1 fault/straggler-weighted route matrix — is
    computed lazily: baseline policies that only need hop distances never
    pay for route weighting, and fault-aware policies hit the engine's
    per-(topology, health) cache.
    """

    request: object                 # the originating PlacementRequest
    G_w: np.ndarray                 # guest edge weights under request.metric
    coords: np.ndarray              # (N, ndim) host coordinates
    hops: np.ndarray                # healthy hop-distance matrix (cached)
    p_f: np.ndarray                 # outage probs, unavailable pinned to 1.0
    available: np.ndarray           # allocatable node ids (order-preserving)
    rng: np.random.Generator
    _weights_fn: Optional[Callable[[], np.ndarray]] = None
    _weights: Optional[np.ndarray] = None
    # engine-owned memo dict scoped to one (topology, health) state: policies
    # stash guest-independent intermediates (e.g. TOFA's window/ball node-set
    # candidates) here so repeated placements against the same health
    # snapshot skip re-deriving them.  None when no engine cache backs the
    # call (ad-hoc contexts in tests).
    shared: Optional[dict] = None
    # disambiguates availability inside a shared dict: the engine scopes
    # shared dicts per *route* health key (so busy-overlay churn reuses one
    # dict per epoch), and every memo entry is namespaced by this token —
    # the request state's full key — because candidate node sets depend on
    # which nodes are currently selectable, not just on route weights.
    avail_token: Optional[tuple] = None

    def memo(self, key, fn: Callable[[], object]):
        """Return ``fn()`` memoised under ``(key, avail_token)`` in the
        engine-scoped ``shared`` dict (or uncached when no dict was
        provided).  The availability namespace keeps entries correct when
        one shared dict serves many busy-overlay views of one epoch."""
        if self.shared is None:
            return fn()
        key = (key, self.avail_token)
        if key not in self.shared:
            self.shared[key] = fn()
        return self.shared[key]

    @property
    def n_procs(self) -> int:
        return self.G_w.shape[0]

    @property
    def weights(self) -> np.ndarray:
        if self._weights is None:
            self._weights = (self._weights_fn() if self._weights_fn is not None
                             else self.hops)
        return self._weights

    @property
    def weights_computed(self) -> bool:
        return self._weights is not None


@dataclasses.dataclass
class PolicyOutput:
    """What a policy returns: the placement plus policy-specific diagnostics."""

    placement: np.ndarray
    used_consecutive_window: bool = False   # TOFA step 10 succeeded?


@runtime_checkable
class PlacementPolicy(Protocol):
    """The protocol every registered policy class implements."""

    name: ClassVar[str]
    fault_aware: ClassVar[bool]

    def place(self, ctx: PolicyContext) -> PolicyOutput: ...


_REGISTRY: dict[str, type] = {}


def register_policy(name: str):
    """Class decorator: register a :class:`PlacementPolicy` under ``name``."""
    def deco(cls):
        if name in _REGISTRY:
            raise DuplicatePolicyError(
                f"policy {name!r} already registered by "
                f"{_REGISTRY[name].__name__}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_policy(name: str) -> PlacementPolicy:
    """Instantiate the policy registered under ``name``."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise UnknownPolicyError(
            f"unknown policy {name!r}; registered: "
            f"{', '.join(_REGISTRY) or '(none)'}") from None
    return cls()


def unregister_policy(name: str) -> None:
    """Remove a registered policy (tests / plugin teardown)."""
    if name not in _REGISTRY:
        raise UnknownPolicyError(f"unknown policy {name!r}")
    del _REGISTRY[name]


def available_policies() -> tuple[str, ...]:
    """Registered policy names, in registration order."""
    return tuple(_REGISTRY)
