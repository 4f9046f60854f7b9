"""The port's device mesh: named axes over the default process group.

This module takes the place of the JAX package's ``repro.distributed.compat``
(``shard_map_compat``, ``pcast_varying``): where the reference runs one
``shard_map`` body on every device of a ``jax.sharding.Mesh``, the port runs
one program per rank of ``torch.distributed``, and the collectives of that
body (``psum``, ``all_gather`` over one mesh axis or several) go over a
process group per set of axes.

Mesh coordinates are row-major in the rank: rank ``r`` of a ``(2, 2, 2)``
mesh over ``("pod", "data", "model")`` sits at ``(r // 4, r // 2 % 2,
r % 2)``.  :meth:`Mesh.axis_index` folds coordinates in the order the axes
are named, as the reference's shard index does (``pod * data_size +
data``), so point shard ``i`` holds point range ``i`` in both packages.

Every group is made by :func:`torch.distributed.new_group`, called by every
rank for every group in one fixed order when the mesh is made.  A set of
axes that spans every rank uses the default group; one of size 1 in a larger
world needs no collective at all.  Without an initialised process group the
mesh must have one rank, and every collective is the identity.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "Axes"]

Axes = str | Sequence[str]

_TRIVIAL = "trivial"  # a group of one rank: every collective is the identity


class Mesh:
    """Named axes of sizes ``shape`` over the default process group.

    ``shape`` multiplies to the world size; ``axis_names`` are distinct.
    ``shape`` (like ``jax.sharding.Mesh.shape``) maps each name to its
    size.  This rank's coordinates are row-major in its rank.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"need one distinct name per axis, got {shape} / {names}")
        if min(shape, default=1) < 1:
            raise ValueError(f"axis sizes must be >= 1, got {shape}")
        self.initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.initialized else 1
        self.rank = dist.get_rank() if self.initialized else 0
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(names, shape))} needs {math.prod(shape)} ranks, "
                             f"the world has {world}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.world_size = world
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(self.rank, shape))))
        self._groups: dict[frozenset, object] = {}
        # every subset of axes, in one order on every rank
        for r in range(1, len(names) + 1):
            for subset in itertools.combinations(names, r):
                self._groups[frozenset(subset)] = self._make_groups(subset)

    def _make_groups(self, subset: tuple[str, ...]):
        """This rank's group over ``subset``: the ranks that share its
        coordinates on every other axis."""
        size = math.prod(self.shape[a] for a in subset)
        if not self.initialized or (size == 1 and self.world_size > 1):
            return _TRIVIAL
        if size == self.world_size:
            return None  # the default group
        grid = np.arange(self.world_size).reshape(tuple(self.shape.values()))
        keep = [i for i, a in enumerate(self.axis_names) if a in subset]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        members = grid.transpose(rest + keep).reshape(-1, size)  # one row per group
        mine = None
        for row in members:
            g = dist.new_group(ranks=sorted(int(r) for r in row))
            if self.rank in row:
                mine = g
        return mine

    @staticmethod
    def _names(axes: Axes) -> tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes: Axes) -> int:
        """Ranks along ``axes`` (one name or several)."""
        return math.prod(self.shape[a] for a in self._names(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, row-major in the order named."""
        return self._index_of(self.rank, axes)

    def group(self, axes: Axes):
        """The process group over ``axes`` (``None``: the default group)."""
        names = self._names(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh has no axes {unknown} (axes: {self.axis_names})")
        return self._groups[frozenset(names)]

    def psum(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum of ``t`` over the ranks along ``axes``, in ``t``'s dtype (a
        new tensor; ``t`` is left as it was)."""
        g = self.group(axes)
        out = t.clone()
        if g is not _TRIVIAL:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
        return out

    def all_gather(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``(size(axes), *t.shape)``: every rank's ``t`` along ``axes``,
        listed by :meth:`axis_index` over ``axes``."""
        g = self.group(axes)
        if g is _TRIVIAL:
            return t[None].clone()
        flat = t.contiguous()
        out = [torch.empty_like(flat) for _ in range(dist.get_world_size(g))]
        dist.all_gather(out, flat, group=g)
        # the group lists its ranks in ascending global rank; reorder them
        # into the row-major order of ``axes`` as named
        members = sorted(dist.get_process_group_ranks(g) if g is not None
                         else range(self.world_size))
        order = np.argsort([self._index_of(r, axes) for r in members])
        return torch.stack([out[i] for i in order])

    def _index_of(self, rank: int, axes: Axes) -> int:
        coords = dict(zip(self.axis_names,
                          (int(c) for c in np.unravel_index(rank, tuple(self.shape.values())))))
        idx = 0
        for a in self._names(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def barrier(self) -> None:
        if self.initialized:
            dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"
