"""Plain PyTorch version of the candidate rerank: exact fp32 squared L2
between each query and its gathered candidate rows."""

from __future__ import annotations

import torch

from repro_torch.core.distances import rowwise_candidate_dist


def gather_rerank_block_ref(
    cols: torch.Tensor, x: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """``cols: (m, c)`` row ids into ``x: (n, d)``, ``q: (m, d) -> (m, c)``
    squared L2 (ids already clipped by the op)."""
    xc = x[cols.long()]  # (m, c, d)
    return rowwise_candidate_dist(q, xc, "l2")
