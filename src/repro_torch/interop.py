"""Carry inputs across from the reference's plain arrays.

The reference package (``repro``) and this port each have their own
``CommGraph``, ``ClusterState``, topologies, ``PlacementRequest`` and
model classes; the port imports nothing of ``repro``.  What the two share
is data: guest matrices, torus extents or fat-tree arity, outage beliefs,
straggler factors and lifecycle codes, all plain NumPy arrays or ints,
and a model's parameters as a nested dict of NumPy arrays.  These
functions build the port's objects from that data, so a test can place
the same job, or run the same model, with both packages and compare the
results.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .core.comm_graph import CommGraph
from .core.engine import PlacementRequest
from .core.fattree import FatTreeTopology
from .core.state import ClusterState
from .core.topology import TorusTopology
from .models.model import (Transformer, leaf_paths, param_leaves,
                           schema)


def comm_graph(G_v: np.ndarray, G_m: Optional[np.ndarray] = None
               ) -> CommGraph:
    """The guest graph from its (n, n) byte and message matrices."""
    G_v = np.array(G_v, dtype=np.float64)
    n = G_v.shape[0]
    G_m = (np.zeros((n, n)) if G_m is None
           else np.array(G_m, dtype=np.float64))
    return CommGraph(n, G_v=G_v, G_m=G_m)


def topology(*, torus_dims: Optional[Sequence[int]] = None,
             fattree_k: Optional[int] = None):
    """A torus from its extents, or a k-ary fat tree from its arity."""
    if (torus_dims is None) == (fattree_k is None):
        raise ValueError("give exactly one of torus_dims, fattree_k")
    if torus_dims is not None:
        return TorusTopology(tuple(int(d) for d in torus_dims))
    return FatTreeTopology(int(fattree_k))


def cluster_state(health: np.ndarray, p_f: Optional[np.ndarray] = None
                  ) -> ClusterState:
    """A health snapshot from per-node lifecycle codes (the reference's
    ``ClusterState.health``: 0 UP, 1 DEGRADED, 2 DRAINED, 3 DOWN) and
    outage beliefs.  Each call mints a new epoch unless the arrays
    describe the all-healthy state; reuse the returned object to keep
    the engine's epoch-keyed caches warm."""
    health = np.asarray(health, dtype=np.int8)
    n = len(health)
    p = np.zeros(n) if p_f is None else np.asarray(p_f, dtype=np.float64)
    return ClusterState.healthy(n).evolve(health=health, p_f=p)


def request(G_v: np.ndarray, G_m: Optional[np.ndarray] = None, *,
            torus_dims: Optional[Sequence[int]] = None,
            fattree_k: Optional[int] = None,
            state: Optional[ClusterState] = None,
            p_f: Optional[np.ndarray] = None,
            available: Optional[np.ndarray] = None,
            straggler: Optional[np.ndarray] = None,
            metric: str = "volume", seed: int = 0) -> PlacementRequest:
    """A placement request from the reference's arrays.

    Health travels either as a port ``state`` (see :func:`cluster_state`)
    or as the legacy ``(p_f, available)`` arrays, exactly as the
    reference's ``PlacementRequest`` takes them — the legacy path interns
    by content, so equal arrays give one epoch in both packages.
    """
    return PlacementRequest(
        comm=comm_graph(G_v, G_m),
        topology=topology(torus_dims=torus_dims, fattree_k=fattree_k),
        state=state, p_f=p_f, available=available, straggler=straggler,
        metric=metric, seed=seed)


def model_params(cfg, params_np: dict, *, device="cuda",
                 dtype: torch.dtype = torch.float32) -> Transformer:
    """A :class:`~repro_torch.models.model.Transformer` (any family the
    port runs) holding the reference's parameters.

    ``params_np`` is the reference's nested parameter dict as NumPy
    arrays, for example ``jax.tree.map(np.asarray, repro.models.model.
    init(cfg, key))``, with each group's leaves stacked over a leading
    layer axis, nested groups at any depth (an encoder-decoder model's
    ``decoder/self/wq``); layer ``l`` of a group gets slice ``[l]`` of
    each of its leaves, a hybrid model's ``shared`` block slice ``[0]``.
    Every leaf of the schema must be there at its shape (else
    ``ValueError``), and nothing else (else ``KeyError``).  The tensors
    are made on ``device`` in ``dtype``."""
    model = Transformer(cfg, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, path, layer, d in param_leaves(cfg):
            node = params_np
            for key in path:
                node = node[key]
            arr = np.asarray(node)
            if arr.shape != d.shape:
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                                 f"the schema says {d.shape}")
            seen.add(path)
            params[name].copy_(torch.tensor(
                arr if layer is None else arr[layer]))
    extra = sorted("/".join(p) for p, _ in leaf_paths(params_np)
                   if p not in seen)
    if extra:
        raise KeyError(f"parameters the port does not know: {extra}")
    return model


def seeded_params(cfg, seed: int = 0) -> dict:
    """Parameters of a model the port runs drawn with NumPy, in the
    reference's layout (nested dict, each group stacked over its layers),
    float32.

    Each schema leaf in the schema's order, depth first (each group's
    leaves in their own order, where the group stands among its
    siblings; an encoder-decoder model's ``decoder/self`` leaves before
    ``decoder/cross``) is ones, zeros, or ``default_rng(seed)`` standard
    normals times its scale.  Both packages
    can run the same weights from it: the reference takes the dict as it
    is, the port through :func:`model_params`."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return rng.standard_normal(d.shape, dtype=np.float32) \
            * np.float32(d.scale)

    def tree(t: dict) -> dict:
        return {k: tree(d) if isinstance(d, dict) else draw(d)
                for k, d in t.items()}

    return tree(schema(cfg))
