"""Collision counting (Definitions 1 and 4), on torch tensors.

The counterpart of ``repro.core.collision``: a point collides with the
query in subspace ``i`` iff its distance there is at most ``tau_i``, the
``count``-th smallest distance of that subspace; its SC-score is the
number of subspaces in which it collides.
"""

from __future__ import annotations

import torch

__all__ = ["kth_smallest", "collision_thresholds", "collision_mask", "sc_scores"]


def kth_smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (1-indexed) value along the last axis.

    A value selection: the same value as the JAX package's ``lax.top_k`` on
    the negated values, given the same values, on every device; the order
    ``torch.topk`` gives ties cannot change it.  (``torch.kthvalue`` gives
    the same value, but took most of an SC-Linear batch's device time on an
    H100, PERF.md.)
    """
    n = values.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    return torch.topk(values, k, dim=-1, largest=False).values[..., -1].contiguous()


def collision_thresholds(subspace_dists: torch.Tensor, count: int) -> torch.Tensor:
    """``(Ns, n) -> (Ns,)`` per-subspace collision thresholds tau_i."""
    return kth_smallest(subspace_dists, count)


def collision_mask(subspace_dists: torch.Tensor, count: int) -> torch.Tensor:
    """``(Ns, n) -> (Ns, n)`` bool: does point j collide with q in subspace i."""
    tau = collision_thresholds(subspace_dists, count)
    return subspace_dists <= tau[..., None]


def sc_scores(subspace_dists: torch.Tensor, count: int) -> torch.Tensor:
    """``(Ns, n) -> (n,)`` int32 SC-scores (Definition 4)."""
    return collision_mask(subspace_dists, count).sum(dim=0, dtype=torch.int32)
