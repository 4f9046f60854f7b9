"""Subspace sampling and division (paper Definition 3), on torch tensors.

The counterpart of ``repro.core.subspace``: a :class:`SubspaceSpec` says how
the ``d`` dims are permuted and then cut into ``Ns`` contiguous subspaces,
and every ragged view is materialised as a dense zero-padded tensor (zero
padding never changes L1/L2 distances, and K-means centroids of padded
columns stay at zero).  ``sampled_spec`` draws its permutation with numpy's
RNG, so a seed gives the same spec in both packages.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "SubspaceSpec",
    "contiguous_spec",
    "sampled_spec",
    "permute",
    "split_padded",
    "split_query_padded",
    "split_halves_padded",
    "collision_count",
]


@dataclasses.dataclass(frozen=True)
class SubspaceSpec:
    """Static description of a subspace division."""

    d: int
    n_subspaces: int
    perm: tuple[int, ...]
    bounds: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.perm) != self.d:
            raise ValueError(f"perm has {len(self.perm)} entries, expected d={self.d}")
        if sorted(self.perm) != list(range(self.d)):
            raise ValueError("perm is not a permutation of range(d)")
        if len(self.bounds) != self.n_subspaces + 1:
            raise ValueError("bounds must have Ns+1 entries")
        if self.bounds[0] != 0 or self.bounds[-1] != self.d:
            raise ValueError("bounds must span [0, d]")
        for a, b in zip(self.bounds, self.bounds[1:]):
            if b <= a:
                raise ValueError("every subspace must own at least one dim")

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.bounds, self.bounds[1:]))

    @property
    def max_size(self) -> int:
        return max(self.sizes)

    @property
    def half_sizes(self) -> tuple[tuple[int, int], ...]:
        out = []
        for s in self.sizes:
            h1 = math.ceil(s / 2)
            out.append((h1, s - h1))
        return tuple(out)

    @property
    def max_half_size(self) -> int:
        return max(max(h1, h2) for h1, h2 in self.half_sizes)


def _even_bounds(d: int, n_subspaces: int) -> tuple[int, ...]:
    s = d // n_subspaces
    if s == 0:
        raise ValueError(f"d={d} too small for Ns={n_subspaces}")
    return tuple([i * s for i in range(n_subspaces)] + [d])


def contiguous_spec(d: int, n_subspaces: int) -> SubspaceSpec:
    """The paper's practical division: contiguous equal slices (§3.2)."""
    return SubspaceSpec(d, n_subspaces, tuple(range(d)), _even_bounds(d, n_subspaces))


def sampled_spec(d: int, n_subspaces: int, seed: int) -> SubspaceSpec:
    """Definition 3: multi-round uniform sampling without replacement."""
    rng = np.random.default_rng(seed)
    perm = tuple(int(x) for x in rng.permutation(d))
    return SubspaceSpec(d, n_subspaces, perm, _even_bounds(d, n_subspaces))


def permute(spec: SubspaceSpec, x: torch.Tensor) -> torch.Tensor:
    """Apply the dim permutation to the trailing axis of ``x`` (no copy for
    the identity permutation of :func:`contiguous_spec`)."""
    if spec.perm == tuple(range(spec.d)):
        return x
    perm = torch.tensor(spec.perm, dtype=torch.int64, device=x.device)
    return x.index_select(-1, perm)


def split_padded(spec: SubspaceSpec, x: torch.Tensor) -> torch.Tensor:
    """``(..., d) -> (Ns, ..., s_max)`` zero-padded dense subspace view.

    ``x`` must already be permuted (see :func:`permute`).  When every
    subspace has ``s_max`` dims (``d`` divisible by ``Ns``) this is a view of
    ``x``, no copy: subspace ``i`` is ``x[..., i*s:(i+1)*s]``.
    """
    s_max = spec.max_size
    if all(s == s_max for s in spec.sizes):
        return x.unflatten(-1, (spec.n_subspaces, s_max)).movedim(-2, 0)
    parts = [F.pad(x[..., a:b], (0, s_max - (b - a))) for a, b in zip(spec.bounds, spec.bounds[1:])]
    return torch.stack(parts, dim=0)


def split_query_padded(spec: SubspaceSpec, q: torch.Tensor) -> torch.Tensor:
    """Alias of :func:`split_padded`, kept for call-site readability."""
    return split_padded(spec, q)


def split_halves_padded(
    spec: SubspaceSpec, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., d) -> 2 x (Ns, ..., h_max)`` zero-padded half-subspace views.

    ``x`` must already be permuted (see :func:`permute`).
    """
    h_max = spec.max_half_size
    first, second = [], []
    for (a, b), (h1, _h2) in zip(zip(spec.bounds, spec.bounds[1:]), spec.half_sizes):
        for piece, acc in ((x[..., a : a + h1], first), (x[..., a + h1 : b], second)):
            acc.append(F.pad(piece, (0, h_max - piece.shape[-1])))
    return torch.stack(first, dim=0), torch.stack(second, dim=0)


def collision_count(n: int, alpha: float) -> int:
    """Number of per-subspace collisions: the ``alpha * n`` of Definition 1."""
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    return max(1, int(alpha * n))
