"""Distance primitives of the query path, in plain torch.

The counterpart of ``repro.core.distances`` for what the fused query
needs: the batch-padding-invariant rowwise squared L2 that orders the
Dynamic-Activation prefix, and the per-candidate distances of the rerank.
"""

from __future__ import annotations

from typing import Literal

import torch

Metric = Literal["l2", "l1"]

__all__ = ["Metric", "sqdist_rowwise", "l1_rowwise", "pairwise_dist_rowwise",
           "rowwise_candidate_dist"]


def sqdist_rowwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(..., m, d), (..., n, d) -> (..., m, n)`` fp32 squared L2 via the
    broadcast difference.

    The sum runs over ``d`` one dim at a time, in index order, as separate
    elementwise ops.  Each output element therefore rounds the same way
    whatever the batch shape and whatever the device: a zero-padded serving
    bucket returns the unpadded rows bit for bit, and the card and the CPU
    agree exactly on the distances that rank the IMI cells.  O(m*n*d)
    work, so only for small ``n`` (centroid tables).
    """
    qf, xf = q.float(), x.float()
    acc = torch.zeros(
        (*torch.broadcast_shapes(qf.shape[:-2], xf.shape[:-2]), qf.shape[-2], xf.shape[-2]),
        dtype=torch.float32, device=q.device,
    )
    for j in range(qf.shape[-1]):
        diff = qf[..., :, None, j] - xf[..., None, :, j]
        acc = acc + diff * diff
    return acc


def l1_rowwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(..., m, d), (..., n, d) -> (..., m, n)`` L1 via the broadcast
    difference (small ``n`` only)."""
    return torch.sum(torch.abs(q[..., :, None, :] - x[..., None, :, :]), dim=-1)


def pairwise_dist_rowwise(
    q: torch.Tensor, x: torch.Tensor, metric: Metric = "l2"
) -> torch.Tensor:
    """Rowwise pairwise distances under ``metric`` (L2 is squared)."""
    if metric == "l2":
        return sqdist_rowwise(q, x)
    if metric != "l1":
        raise ValueError(f"unknown metric {metric!r}")
    return l1_rowwise(q, x)


def rowwise_candidate_dist(
    q: torch.Tensor, xc: torch.Tensor, metric: Metric = "l2"
) -> torch.Tensor:
    """Exact per-candidate distances ``q: (m, d), xc: (m, c, d) -> (m, c)``.

    L2 accumulates in fp32; L1 reduces in the inputs' promoted dtype.  The
    reduction runs over ``d`` only, so a row's distance does not depend on
    how many candidates or queries ride beside it.
    """
    if metric == "l2":
        diff = q[:, None, :].float() - xc.float()
        return torch.sum(diff * diff, dim=-1)
    if metric != "l1":
        raise ValueError(f"unknown metric {metric!r}")
    return torch.sum(torch.abs(q[:, None, :] - xc), dim=-1)
