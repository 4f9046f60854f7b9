"""The batched K-means passes of the build: Lloyd statistics and the paired
final assignment with the IMI histogram.  Each checks its arguments, then
dispatches on the device of the tensors it was given.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel (:mod:`.kernel`), and a failed build or launch raises.
``block_n`` is the chunk of points: the plain version's memory bound, and
the points each block of the kernel takes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.kmeans_assign import kernel
from repro_torch.kernels.kmeans_assign.ref import (
    kmeans_pair_assign_hist_ref,
    kmeans_stats_ref,
)

__all__ = ["kmeans_stats", "kmeans_pair_assign_hist", "MAX_DIM"]

#: Widest (half-)subspace a kernel thread holds in registers.
MAX_DIM = 64
_SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
_THREADS = 256  # threads per block of the kmeans kernels


def _check(x, centroids, block_n) -> tuple[int, int, int, int]:
    b, n, s = check_tensor("x", x, torch.float32, 3)
    k = check_tensor("centroids", centroids, torch.float32, 3)[1]
    if centroids.shape[0] != b or centroids.shape[2] != s:
        raise ValueError(
            f"centroids must be ({b}, k, {s}), got {tuple(centroids.shape)}"
        )
    if min(b, n, s, k) < 1 or block_n < 1:
        raise ValueError(f"need B, n, s, k and block_n >= 1, got {b}/{n}/{s}/{k}/{block_n}")
    if s > MAX_DIM:
        raise ValueError(f"subspace width {s} exceeds the kernels' {MAX_DIM}")
    return b, n, s, k


def kmeans_stats(
    x: torch.Tensor,
    centroids: torch.Tensor,
    *,
    block_n: int,
    with_assign: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd statistics pass over ``B`` codebooks: ``x: (B, n, s)``,
    ``centroids: (B, k, s)`` -> ``(assign (B, n) int32 | None, sums
    (B, k, s) f32, counts (B, k) f32, inertia (B,) f32)``; ``assign`` only
    ``with_assign``."""
    b, n, s, k = _check(x, centroids, block_n)
    same_device(x, centroids)
    smem = 4 * (k * s + k * (s + 1) + _THREADS * (s + 2))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"k={k}, s={s} need {smem} B of shared memory (> {_SMEM_LIMIT})")
    if x.device.type == "cpu":
        a, sums, counts, inertia = kmeans_stats_ref(x, centroids, block_n=block_n)
        return (a if with_assign else None), sums, counts, inertia
    if x.device.type == "cuda":
        return kernel.kmeans_stats(x, centroids, block_n, with_assign)
    raise ValueError(f"no kmeans_stats route for device {x.device}")


def kmeans_pair_assign_hist(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Final assignment + IMI occupancy: ``x: (2Ns, n, s)``, ``centroids:
    (2Ns, k, s)`` -> ``(assign (2Ns, n) int32, cell_counts (Ns, k*k) int32)``;
    the caller forms ``cell_ids = a1 * k + a2``."""
    b, n, s, k = _check(x, centroids, block_n)
    if b % 2:
        raise ValueError(f"paired layout needs an even batch, got B={b}")
    same_device(x, centroids)
    smem = 4 * (2 * k * s + k * k)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"k={k}, s={s} need {smem} B of shared memory (> {_SMEM_LIMIT})")
    if x.device.type == "cpu":
        return kmeans_pair_assign_hist_ref(x, centroids, block_n=block_n)
    if x.device.type == "cuda":
        return kernel.kmeans_pair_assign_hist(x, centroids, block_n)
    raise ValueError(f"no kmeans_pair_assign_hist route for device {x.device}")
