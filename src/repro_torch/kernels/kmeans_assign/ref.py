"""Plain PyTorch versions of the batched K-means passes: Lloyd statistics,
and the paired final assignment with the IMI occupancy histogram.

Distances are summed one dim at a time (:func:`repro_torch.core.distances.
sqdist_rowwise`), the arithmetic of the CUDA kernels, so the assignments
of the two agree exactly.  The data is processed in chunks of ``block_n``
points, which bounds the ``(B, block_n, k)`` distance block.
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import sqdist_rowwise


def kmeans_stats_ref(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x: (B, n, s)``, ``centroids: (B, k, s)`` -> ``(assign (B, n) int32,
    sums (B, k, s) f32, counts (B, k) f32, inertia (B,) f32)``: each point's
    nearest centroid (lowest index on ties) and the per-centroid sums, counts
    and squared distances."""
    b, n, s = x.shape
    k = centroids.shape[1]
    dev = x.device
    assign = torch.empty((b, n), dtype=torch.int32, device=dev)
    sums = torch.zeros((b * k, s), dtype=torch.float32, device=dev)
    counts = torch.zeros((b * k,), dtype=torch.float32, device=dev)
    inertia = torch.zeros((b,), dtype=torch.float32, device=dev)
    base = (torch.arange(b, device=dev) * k)[:, None]
    for lo in range(0, n, block_n):
        xb = x[:, lo : lo + block_n]
        d2 = sqdist_rowwise(xb, centroids)  # (B, bn, k)
        a = torch.argmin(d2, dim=2)
        best = d2.gather(2, a[..., None])[..., 0]
        flat = (a + base).reshape(-1)
        sums.index_add_(0, flat, xb.reshape(-1, s))
        counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
        inertia += best.sum(dim=1)
        assign[:, lo : lo + block_n] = a.to(torch.int32)
    return assign, sums.reshape(b, k, s), counts.reshape(b, k), inertia


def kmeans_pair_assign_hist_ref(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``x: (2Ns, n, s)``, ``centroids: (2Ns, k, s)`` in SuCo's paired
    half-subspace layout -> ``(assign (2Ns, n) int32, cell_counts (Ns, k*k)
    int32)``, with ``cell_counts[i, a1*k + a2]`` the occupancy of each IMI
    cell of subspace i."""
    b, n, _ = x.shape
    ns, k = b // 2, centroids.shape[1]
    assign = torch.empty((b, n), dtype=torch.int32, device=x.device)
    for lo in range(0, n, block_n):
        d2 = sqdist_rowwise(x[:, lo : lo + block_n], centroids)
        assign[:, lo : lo + block_n] = torch.argmin(d2, dim=2).to(torch.int32)
    cells = assign[:ns].long() * k + assign[ns:].long()
    cells = cells + (torch.arange(ns, device=x.device) * k * k)[:, None]
    counts = torch.bincount(cells.reshape(-1), minlength=ns * k * k)
    return assign, counts.reshape(ns, k * k).to(torch.int32)
