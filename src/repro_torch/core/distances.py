"""Distance primitives of the framework.

The counterpart of ``repro.core.distances``.  The pairwise squared L2 over
a whole dataset (SC-Linear's subspace scan) goes through
:func:`pairwise_sqdist`, whose ``impl="auto"`` dispatches by the tensors'
device to the pairwise-L2 kernel op (the CUDA kernel on the card, its plain
fixed-order version on the CPU).  The rest is plain torch: the
batch-padding-invariant rowwise squared L2 that orders the Dynamic-
Activation prefix, L1 (the JAX package has no kernel for it either), and
the per-candidate distances of the rerank.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels.pairwise_l2 import ops as _pairwise_ops

Metric = Literal["l2", "l1"]

__all__ = ["Metric", "sq_l2", "pairwise_sqdist", "pairwise_dist", "sqdist_rowwise",
           "l1_rowwise", "pairwise_dist_rowwise", "rowwise_candidate_dist"]


def sq_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 between matching rows of ``a`` and ``b``."""
    diff = a - b
    return torch.sum(diff * diff, dim=-1)


def _sqdist_matmul(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(m, d), (n, d) -> (m, n)`` squared L2 via the matmul identity, fp32:
    the counterpart of the JAX package's ``impl="jnp"`` form."""
    qf, xf = q.float(), x.float()
    qn = torch.sum(qf * qf, dim=-1)
    xn = torch.sum(xf * xf, dim=-1)
    d2 = qn[:, None] + xn[None, :] - 2.0 * (qf @ xf.T)
    return d2.clamp_min(0.0)


def pairwise_sqdist(q: torch.Tensor, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Pairwise squared L2 distances ``(m, d), (n, d) -> (m, n)`` fp32.

    ``impl``: ``"auto"`` (the pairwise-L2 kernel op, by the tensors'
    device: its sums run in a fixed order, the same bits on the card and
    the CPU) | ``"jnp"`` (the matmul identity, :func:`_sqdist_matmul`) |
    ``"rowwise"`` (the batch-padding-invariant broadcast form,
    :func:`sqdist_rowwise`).
    """
    if impl == "auto":
        return _pairwise_ops.pairwise_sqdist(q.float(), x.float())
    if impl == "rowwise":
        return sqdist_rowwise(q, x)
    if impl == "jnp":
        return _sqdist_matmul(q, x)
    raise ValueError(f"unknown impl {impl!r}")


def pairwise_dist(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: Metric = "l2",
    *,
    block: int = 16384,
    impl: str = "auto",
) -> torch.Tensor:
    """Pairwise distances under ``metric``; L2 returns *squared* distances.

    L1 is computed in blocks of ``block`` rows of ``x``, which bounds the
    ``(m, block, d)`` broadcast.  (The JAX package pads the last block with
    1e30 rows and slices their columns off; slicing the last block short
    gives the same columns.)
    """
    if metric == "l2":
        return pairwise_sqdist(q, x, impl=impl)
    if metric != "l1":
        raise ValueError(f"unknown metric {metric!r}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    return torch.cat([l1_rowwise(q, x[lo : lo + block]) for lo in range(0, x.shape[0], block)], -1)


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
