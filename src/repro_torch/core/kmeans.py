"""Batched K-means for the SuCo build: chunked Lloyd over ``2*Ns`` small
codebooks, then the paired final assignment with the IMI histogram.

The counterpart of the chunked-Lloyd path of ``repro.core.kmeans``
(``_kmeans_core`` and ``_final_assign``).  Each Lloyd iteration is one
statistics pass (:func:`repro_torch.kernels.kmeans_assign.ops.kmeans_stats`:
the CUDA kernel on the card, the chunked plain version on the CPU) and the
same update rule: ``c <- sums / max(counts, 1)``, an empty cluster keeps its
centroid.  The initial centroids are distinct random rows drawn with a
``torch.Generator``, or ``init_centroids`` given by the caller (the tests
inject the JAX package's seeds, since the two RNGs differ).  The dense and
minibatch modes of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.kmeans_assign.ops import kmeans_pair_assign_hist, kmeans_stats

__all__ = ["KMeansResult", "init_random", "kmeans_batched"]


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (B, k, s)
    assignments: torch.Tensor  # (B, n) int32
    inertia: torch.Tensor  # (B,) — of the last Lloyd update pass
    cell_counts: torch.Tensor  # (B//2, k*k) int32 IMI occupancy


def init_random(xs: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """``(B, n, s) -> (B, k, s)``: ``k`` distinct random rows per codebook.

    The permutations are drawn on the CPU from ``generator``, so a seed gives
    the same rows whatever device ``xs`` lies on."""
    b, n, _ = xs.shape
    if k > n:
        raise ValueError(f"k={k} centroids need at least k points, got n={n}")
    idx = torch.stack([torch.randperm(n, generator=generator)[:k] for _ in range(b)])
    idx = idx.to(xs.device)
    return torch.gather(xs, 1, idx[:, :, None].expand(b, k, xs.shape[2]))


def kmeans_batched(
    xs: torch.Tensor,
    k: int,
    iters: int,
    *,
    block_n: int,
    generator: torch.Generator | None = None,
    init_centroids: torch.Tensor | None = None,
) -> KMeansResult:
    """Chunked Lloyd on ``xs: (B, n, s)`` (B = 2*Ns, first halves then
    second halves), then the paired final assignment and IMI histogram.

    ``init_centroids: (B, k, s)`` overrides the random init drawn from
    ``generator``.
    """
    if init_centroids is None:
        if generator is None:
            raise ValueError("pass a generator or init_centroids")
        c = init_random(xs, k, generator)
    else:
        c = init_centroids.to(device=xs.device, dtype=torch.float32).contiguous()
        if c.shape != (xs.shape[0], k, xs.shape[2]):
            raise ValueError(
                f"init_centroids must be {(xs.shape[0], k, xs.shape[2])}, got {tuple(c.shape)}"
            )
    inertia = torch.zeros(xs.shape[0], dtype=torch.float32, device=xs.device)
    for _ in range(iters):
        _, sums, counts, inertia = kmeans_stats(xs, c, block_n=block_n)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        c = torch.where(counts[..., None] > 0, new, c).contiguous()
    assign, cell_counts = kmeans_pair_assign_hist(xs, c, block_n=block_n)
    return KMeansResult(c, assign, inertia, cell_counts)
