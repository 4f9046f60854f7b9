"""The vocabulary of sharding, below the models, the kernels and the
launchers that all use it: partition specs over named mesh axes, their
``DTensor`` placements, and the logical activation rules with
:func:`constrain` (the counterpart of ``repro.models.shard_ctx``'s; the
port's :mod:`repro_torch.models.shard_ctx` re-exports them).

Specs.  A :class:`Spec` names, per tensor dim, a mesh axis, a tuple of
axes, or ``None``, as a ``jax.sharding.PartitionSpec`` does.  DTensors live
on :func:`placement_mesh`: a mesh with the fsdp axes ``("pod", "data")``
flattened into one dim (:data:`FLAT`), so that the fsdp gather of a
parameter is one collective; :func:`to_placements` turns a spec on the
named mesh into placements there.

Logical rules.  Model code never names mesh axes; it marks activations
with *logical* dims:

    q = constrain(q, "batch", ("heads", "qseq"), ("qseq",), None)

A launcher installs a mapping {logical dim -> mesh axis (or axes)} with
:func:`activation_sharding`; :func:`constrain` resolves it per tensor with
the reference's two rules:

  * an axis is applied only where its size divides the dim exactly,
  * each mesh axis is used at most once per tensor (the first logical dim
    that can take it wins),

so a GQA model whose heads do not divide the tensor axis falls back to the
next logical dim the tensor offers (sequence parallelism for attention).
Where the reference's ``with_sharding_constraint`` pins a layout for
GSPMD, ``constrain`` redistributes a ``DTensor`` to the resolved
placements.  Outside a context, or on a plain tensor, it returns its
argument: the unsharded paths run exactly as they did.

This is a module of the package's top level, not of
:mod:`repro_torch.distributed`, whose ``__init__`` imports the sharded
engine and with it the kernels that import this module.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["Spec", "FLAT", "FSDP_DIMS", "axis_sizes", "dim_sizes", "fsdp_axes", "batch_axes",
           "placement_mesh", "to_placements", "is_dtensor", "DEFAULT_RULES",
           "activation_sharding", "resolve", "constrain"]

#: the placement mesh's dim that carries the flattened fsdp axes
FLAT = "pod_data"
#: the placement mesh's dims that carry fsdp axes (one of them at a time)
FSDP_DIMS = (FLAT, "pod", "data")

# default logical rules for the production mesh
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    # merged (batch*heads) dim of the linear-attention kernels: spread over
    # the whole mesh (heads fold into the tensor axis)
    "batch_heads": ("pod", "data", "model"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qseq": ("model",),  # fallback target when heads don't divide
    "ffn": ("model",),
    "expert": ("model",),
    "embed": (),  # activations keep d_model replicated
    "vocab": ("model",),
    "kvseq": (),
}

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_sharding", default=None)
_PLACEMENT_MESHES: dict[int, tuple[DeviceMesh, DeviceMesh]] = {}


class Spec(tuple):
    """A partition spec: one entry per tensor dim (trailing dims may be
    left out), each a mesh axis name, a tuple of names, or ``None``
    (replicated); the port's counterpart of ``jax.sharding.PartitionSpec``,
    and normalised as it is (a one-name tuple is the name, an empty one
    ``None``), so the two are equal as tuples."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh``, or of a stand-in with a
    ``shape`` dict and ``axis_names`` (as the reference's tests use)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, dim_sizes(mesh)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def dim_sizes(mesh: DeviceMesh) -> tuple[int, ...]:
    """The sizes of a ``DeviceMesh``'s dims (read without building its rank
    tensor, which a fake-tensor mode would refuse)."""
    return tuple(int(mesh.size(i)) for i in range(mesh.ndim))


def fsdp_axes(mesh) -> tuple[str, ...]:
    """Axes used to shard the parameter 'data' dimension (ZeRO / FSDP)."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def placement_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh DTensors live on: ``mesh`` with the fsdp axes ``("pod",
    "data")`` flattened into one dim, :data:`FLAT` (row-major, so the rank
    layout is ``mesh``'s); ``mesh`` itself when it has one fsdp axis or
    none.  Made once per mesh, by every rank at the same point (each dim is
    a new process group)."""
    names = tuple(mesh.mesh_dim_names)
    fsdp = fsdp_axes(mesh)
    if len(fsdp) < 2:
        return mesh
    got = _PLACEMENT_MESHES.get(id(mesh))
    if got is not None and got[0] is mesh:
        return got[1]
    rest = [a for a in names if a not in fsdp]
    if names[:len(fsdp)] != fsdp:
        raise ValueError(f"the fsdp axes {fsdp} must lead the mesh's dims {names}")
    sizes = axis_sizes(mesh)
    shape = (sizes["pod"] * sizes["data"], *(sizes[a] for a in rest))
    flat = DeviceMesh(mesh.device_type, mesh.mesh.reshape(shape),
                      mesh_dim_names=(FLAT, *rest))
    _PLACEMENT_MESHES[id(mesh)] = (mesh, flat)
    return flat


def to_placements(mesh: DeviceMesh, spec, ndim: int) -> list:
    """The placements on :func:`placement_mesh` that shard a tensor of
    ``ndim`` dims as ``spec`` does on ``mesh``.

    A dim over several axes becomes ``Shard(d)`` on each of their mesh
    dims; DTensor nests those shards in mesh order, which is the
    reference's row-major order only when the tuple names the axes in mesh
    order, so another order raises (``_StridedShard`` is not used).  The
    fsdp axes go together (they are one dim of the placement mesh)."""
    names = tuple(mesh.mesh_dim_names)
    fsdp = fsdp_axes(mesh)
    pdims = tuple(placement_mesh(mesh).mesh_dim_names)
    out: list = [Replicate()] * len(pdims)
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    if len(entries) != ndim:
        raise ValueError(f"{spec} has more entries than the tensor's {ndim} dims")
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: dim {d} names {axes} out of the mesh's order {names}")
        group = tuple(a for a in axes if a in fsdp)
        if len(fsdp) > 1 and group and group != fsdp:
            raise ValueError(f"{spec}: dim {d} takes {group} of the flattened axes {fsdp}")
        for a in axes:
            pdim = pdims.index(FLAT) if (len(fsdp) > 1 and a in fsdp) else pdims.index(a)
            if isinstance(out[pdim], Shard) and out[pdim].dim != d:
                raise ValueError(f"{spec}: mesh axis {a!r} shards two dims")
            out[pdim] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    token = _CTX.set((mesh, dict(DEFAULT_RULES, **(rules or {}))))
    try:
        yield
    finally:
        _CTX.reset(token)


def resolve(mesh, rules: dict, shape: Sequence[int],
            logical: Sequence[str | Sequence[str] | None]) -> Spec:
    """The spec ``constrain`` gives a tensor of ``shape`` on ``mesh`` under
    ``rules``: each entry a logical dim name, a tuple of *candidate* names
    (the first that divides and is free wins), or ``None``."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    spec = []
    for dim, names in zip(shape, logical):
        if names is None:
            spec.append(None)
            continue
        cands = (names,) if isinstance(names, str) else tuple(names)
        chosen = None
        for name in cands:
            axes = tuple(a for a in rules.get(name, ()) if a in sizes)
            if not axes or any(a in used for a in axes):
                continue
            if dim % math.prod(sizes[a] for a in axes) == 0:
                chosen = axes
                break
        if chosen:
            used.update(chosen)
            spec.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            spec.append(None)
    spec += [None] * (len(shape) - len(spec))
    return Spec(*spec)


def constrain(x: torch.Tensor, *logical: str | Sequence[str] | None) -> torch.Tensor:
    """``x`` redistributed to the active logical rules' placements; ``x``
    itself outside a context or when it is not a ``DTensor``."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    placements = to_placements(mesh, resolve(mesh, rules, x.shape, logical), x.ndim)
    if list(x.placements) == placements:
        return x
    return x.redistribute(placement_mesh(mesh), placements)
