"""Production and debug meshes (the counterpart of ``repro.launch.mesh``):
``torch.distributed`` ``DeviceMesh``es with named dims.

Single pod: (data, model) = (16, 16), 256 ranks.
Multi-pod:  (pod, data, model) = (2, 16, 16), 512 ranks.

Each mesh is built over the default process group, row-major in the rank:
rank ``r`` of a ``(2, 2, 2)`` mesh over ``("pod", "data", "model")`` sits
at ``(r // 4, r // 2 % 2, r % 2)``, the layout of
:class:`repro_torch.distributed.compat.Mesh`.  The functions build nothing
at import; a process group must be initialised first (``gloo`` on the CPU,
``nccl`` on the card, ``fake`` for a dry-run).

The reference's ``compat_make_mesh`` has no counterpart: it bridges a JAX
API change only.  ``fsdp_axes`` and ``batch_axes`` live in
:mod:`repro_torch.placements` with the rest of the sharding vocabulary.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.placements import batch_axes, fsdp_axes, placement_mesh

__all__ = ["make_mesh", "make_production_mesh", "make_debug_mesh", "fsdp_axes", "batch_axes",
           "MESHES"]

#: the launcher's ``--mesh`` names: their shapes and dim names
MESHES = {
    "debug": ((2, 2, 2), ("pod", "data", "model")),
    "prod": ((16, 16), ("data", "model")),
    "prod2": ((2, 16, 16), ("pod", "data", "model")),
}


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over ``axes``, row-major in the rank of
    the default process group, whose world size must equal the mesh's
    size; its :func:`~repro_torch.placements.placement_mesh` is made with
    it."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != size:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs a process group of {size} "
                         f"ranks, the world has {world}")
    mesh = DeviceMesh(device_type, torch.arange(size).reshape(shape), mesh_dim_names=tuple(axes))
    placement_mesh(mesh)  # its groups made now, by every rank at the same point
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape, axes = MESHES["prod2" if multi_pod else "prod"]
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(shape=(2, 2, 2), device_type: str = "cpu") -> DeviceMesh:
    """A small mesh for CPU tests: the last ``len(shape)`` of ``("pod",
    "data", "model")``."""
    axes = ("pod", "data", "model")[-len(shape):]
    return make_mesh(tuple(shape), axes, device_type)
