"""Production meshes + TOFA rank order for a ``DeviceMesh``.

``make_production_mesh`` builds the logical mesh (a FUNCTION, never a
module-level constant: importing this module touches no distributed
state) over the process group already started.  ``make_tofa_mesh`` is
`srun --distribution=TOFA` for a device mesh: it reads the profiled step's
collectives (``core.profiler.profile_torch``), runs TOFA against the H100
fabric (:class:`~repro_torch.core.placement.GpuFabric`) and the GPUs'
health, and builds the mesh from the permuted rank list.  The program is
identical; only which GPU owns which logical coordinate changes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def production_shape(multi_pod: bool) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``, over the started process group
    (ranks in row-major order)."""
    from repro_torch.parallel.sharding import make_mesh
    shape, axes = production_shape(multi_pod)
    return make_mesh(device_type, shape, axes)


def make_mesh_with_devices(ranks, shape, axes, device_type="cuda"):
    """A mesh from an explicit (possibly permuted) rank list: logical
    coordinate k (row-major) runs on rank ``ranks[k]``."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = torch.as_tensor(np.asarray(ranks, dtype=np.int64)).reshape(shape)
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axes))


def make_tofa_mesh(
    profile,
    *,
    multi_pod: bool = False,
    p_f: Optional[np.ndarray] = None,
    state=None,
    policy: str = "tofa",
    engine=None,
    device=None,
    device_type: str = "cuda",
    shape: Optional[tuple] = None,
    axes: Optional[tuple] = None,
):
    """Rank-permuted production mesh.

    1. ``profile`` (``core.profiler.profile_torch`` of the step, or any
       ``HloProfile``) gives the per-shard traffic matrix (the paper's
       LoadMatrix input);
    2. the requested registry policy runs through the
       :class:`~repro_torch.core.engine.PlacementEngine` against the H100
       fabric of that many GPUs (FATT input) and their health: pass
       ``state`` (a versioned :class:`~repro_torch.core.state.
       ClusterState` over GPUs) so repeated mesh builds against one health
       epoch reuse the engine's cached fabric matrices; the raw ``p_f``
       kwarg remains as a shim.  ``engine`` places, else the default
       engine on ``device`` (``cuda`` when omitted);
    3. the permutation orders the ranks of a ``device_type`` mesh of
       ``shape`` / ``axes`` (the production mesh's by default).

    Returns (mesh, DeviceAssignment): logical shard k runs on rank
    ``assignment.permutation[k]``; the assignment carries hop-bytes
    before/after for the roofline's placement term."""
    from repro_torch.core.placement import assign_devices
    from repro_torch.core.profiler import comm_graph_from_profile
    from repro_torch.launch.roofline import production_fabric

    if shape is None:
        shape, axes = production_shape(multi_pod)
    n = int(np.prod(shape))
    comm = comm_graph_from_profile(profile, n_devices=n)
    assignment = assign_devices(comm, production_fabric(n), policy=policy,
                                p_f=p_f, state=state, engine=engine,
                                device=device)
    # ranks are node-major (torchrun's order), so rank id == position
    # in the fabric
    mesh = make_mesh_with_devices(assignment.permutation, shape, axes,
                                  device_type)
    return mesh, assignment
