"""Logical activation-sharding context (the counterpart of
``repro.models.shard_ctx``).

``DEFAULT_RULES``, :func:`activation_sharding` and :func:`constrain` (a
``redistribute`` to the resolved placements under a context, the identity
outside one or on a plain tensor) are :mod:`repro_torch.placements`',
re-exported here: the kernels constrain their inputs too, and import them
from there.

:func:`gather_fsdp` is the ZeRO-3 gather of a weight at its use (its fsdp
dim replicated, its tensor-parallel dim kept): GSPMD infers it from the
batch-sharded activations, DTensor's propagation would instead pick the
cheaper of that and a partial sum over the contraction dim by size, which
changes the arithmetic from cell to cell.  Its backward is the gradient's
reduce-scatter.  :func:`sharded` is the context a sharded step runs in:
the logical rules (unless ``act_sharding=False``) and DTensor's implicit
replication of the plain tensors the model makes itself (position ids,
masks, zeros).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.placements import (
    DEFAULT_RULES,
    FSDP_DIMS,
    activation_sharding,
    constrain,
    dim_sizes,
    resolve,
)

_MESH: contextvars.ContextVar = contextvars.ContextVar("sharded_mesh", default=None)

__all__ = ["activation_sharding", "constrain", "resolve", "DEFAULT_RULES", "gather_fsdp",
           "sharded", "splittable", "mergeable", "whole_rows", "current_mesh"]


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight ``DTensor`` with its fsdp mesh dim replicated (one
    all-gather), any other placement kept; a plain tensor as it is."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = [Replicate() if n in FSDP_DIMS else p for n, p in zip(names, w.placements)]
    if list(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def splittable(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready to have ``dim`` split into ``(n, -1)`` (heads): a
    ``DTensor`` sharded on ``dim`` over mesh dims whose sizes do not divide
    ``n`` is replicated on them first (DTensor refuses an uneven split;
    GSPMD replicates there too, as ``constrain`` then resolves the heads to
    no axis); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    sizes = dim_sizes(x.device_mesh)
    on = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    if n % math.prod(sizes[i] for i in on) == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if i in on else p
                                          for i, p in enumerate(x.placements)])


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` with its last dim whole on every rank and no partial
    sum (each reduced), other shardings kept: what a norm over the last dim
    needs.  DTensor would otherwise carry a partial residual through the
    norm (its scaling is linear) into the next product, which it then runs
    at full width on every rank of the tensor axis.  A plain tensor as it
    is."""
    if not isinstance(x, DTensor):
        return x
    last = Shard(x.ndim - 1)
    want = [Replicate() if p.is_partial() or p == last else p for p in x.placements]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def mergeable(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` ready to have ``dim`` merged into the dim before it (``(B, H)``
    into ``B * H``): a ``DTensor`` sharded on ``dim`` is replicated there
    first, which DTensor may refuse to do inside the reshape; a plain tensor
    as it is."""
    if not isinstance(x, DTensor) or Shard(dim % x.ndim) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p == Shard(dim % x.ndim) else p
                                          for p in x.placements])


@contextlib.contextmanager
def sharded(mesh, act_sharding: bool = True, rules: dict | None = None):
    """The context of a step over ``DTensor`` arguments (see the module's
    note)."""
    token = _MESH.set(mesh)
    try:
        with contextlib.ExitStack() as stack:
            if act_sharding:
                stack.enter_context(activation_sharding(mesh, rules))
            stack.enter_context(implicit_replication())
            yield
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the active :func:`sharded` context, or ``None``."""
    return _MESH.get()
