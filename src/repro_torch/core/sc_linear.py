"""Candidate pools of the SC framework: result type, pool width, and the
exact (score desc, id asc) pool merge of the fused query.

The counterpart of the parts of ``repro.core.sc_linear`` that the fused
SuCo query uses.  The JAX package selects with ``lax.top_k``, whose ties go
to the lower position; ``torch.topk`` promises no order among ties on the
card, so every selection here is a stable sort of a composite int64 key
instead: one exact order, the same on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "QueryResult",
    "candidate_pool_size",
    "score_id_key",
    "merge_topk_pool_with_dists",
]

INT32_MAX = 2**31 - 1


class QueryResult(NamedTuple):
    ids: torch.Tensor  # (..., k) int32 — dataset row ids, ascending distance
    dists: torch.Tensor  # (..., k) — squared L2 (or L1) distances
    scores: torch.Tensor  # (..., k) int32 — SC-scores of the returned points


def candidate_pool_size(n: int, k: int, beta: float) -> int:
    """Candidate-pool width for the re-rank: ``beta * n`` clamped to
    ``[k, n]`` (never larger than ``max(k, n)``; callers validate
    ``k <= n`` separately)."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return max(k, min(int(beta * n), n))


def score_id_key(scores: torch.Tensor, ids: torch.Tensor, smax: int) -> torch.Tensor:
    """int64 key whose ascending order is (score desc, id asc).

    ``scores`` lie in ``[-1, smax]`` (the -1 sentinel and the SC-scores
    ``0..Ns``) and ``ids`` in ``[0, INT32_MAX]``, so ``smax - score`` fits
    the high word and the id the low 32 bits.
    """
    return ((smax - scores.to(torch.int64)) << 32) | ids.to(torch.int64)


def merge_topk_pool_with_dists(
    pool_scores: torch.Tensor,
    pool_dists: torch.Tensor,
    pool_ids: torch.Tensor,
    blk_scores: torch.Tensor,
    blk_dists: torch.Tensor,
    blk_ids: torch.Tensor,
    *,
    smax: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge a ``(score, dist, id)`` block into the carried top pool.

    ``pool_*: (m, p)``, ``blk_*: (m, b)`` -> three ``(m, p)`` tensors: the
    first ``p`` entries of the concatenation in (score desc, id asc) order.
    Entries equal in both keys (only the ``(-1, INT32_MAX, +inf)``
    sentinels) keep their concatenated order — the stable sort — which is
    also ``lax.top_k``'s rule, so the pool equals the JAX package's for
    every ``merge_impl``.  Distances ride along and take no part in the
    selection.
    """
    p = pool_scores.shape[-1]
    s = torch.cat([pool_scores, blk_scores], dim=-1)
    dd = torch.cat([pool_dists, blk_dists], dim=-1)
    i = torch.cat([pool_ids, blk_ids], dim=-1)
    _, pos = torch.sort(score_id_key(s, i, smax), dim=-1, stable=True)
    pos = pos[..., :p]
    return s.gather(-1, pos), dd.gather(-1, pos), i.gather(-1, pos)
