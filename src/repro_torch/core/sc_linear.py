"""SC-Linear (paper Algorithm 1) and the candidate pools of the SC
framework: result type, pool width, the exact rerank, and the exact
(score desc, id asc) pool merges of the streaming and fused queries.

The counterpart of ``repro.core.sc_linear``.  The JAX package selects with
``lax.top_k``, whose ties go to the lower position; ``torch.topk``
promises no order among ties on the card, so every selection here is a
stable sort instead (of the scores, or of a composite int64 key): one exact
order, the same on every device.  The JAX package's merge methods
(``"topk"``, ``"sort"``, ``"counting"``) all give this one selection on the
pools its callers build, so the port keeps one merge.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import subspace
from repro_torch.core.collision import kth_smallest
from repro_torch.core.distances import Metric, pairwise_dist, rowwise_candidate_dist
from repro_torch.kernels.gather_rerank.ops import gather_rerank_block
from repro_torch.kernels.sc_score.ops import sc_scores_fused

__all__ = [
    "QueryResult",
    "candidate_pool_size",
    "score_id_key",
    "sc_scores_from_subspaces",
    "candidate_dists",
    "rerank_candidates",
    "rerank",
    "merge_topk_pool",
    "merge_topk_pool_with_dists",
    "sc_linear_query",
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


def _top_positions(s: torch.Tensor, i: torch.Tensor, p: int, smax: int) -> torch.Tensor:
    """Positions of the first ``p`` entries of each row in (score desc, id
    asc) order: a stable sort, so entries equal in both keys (only the
    sentinels) keep their order, which is also ``lax.top_k``'s rule."""
    return torch.sort(score_id_key(s, i, smax), dim=-1, stable=True).indices[..., :p]


def sc_scores_from_subspaces(
    xs: torch.Tensor, qs: torch.Tensor, count: int, metric: Metric = "l2"
) -> torch.Tensor:
    """``xs: (Ns, n, s), qs: (Ns, m, s) -> (m, n)`` int32 SC-scores.

    Per subspace, the ``(m, n)`` distances give each query's collision
    threshold ``tau`` (the ``count``-th smallest distance, Definition 1).
    For L2 the pairwise-L2 kernel takes each subspace's distances, and
    the SC-score kernel then recomputes them all, compares them with
    ``tau`` and counts the collisions without writing the ``(Ns, m, n)``
    distances: the same fixed-order arithmetic, so the counts are exactly
    those of the distances ``tau`` came from.  L1 counts each subspace's
    block in plain torch.
    """
    m, n = qs.shape[1], xs.shape[1]
    if metric == "l2":
        tau = torch.stack([kth_smallest(pairwise_dist(q_i, x_i), count) for x_i, q_i in zip(xs, qs)])
        return sc_scores_fused(qs.float(), xs.float(), tau)
    scores = torch.zeros((m, n), dtype=torch.int32, device=xs.device)
    for x_i, q_i in zip(xs, qs):
        d = pairwise_dist(q_i, x_i, metric)
        scores += d <= kth_smallest(d, count)[:, None]
    return scores


def candidate_dists(
    x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, metric: Metric = "l2"
) -> torch.Tensor:
    """Exact distances of candidate rows ``ids: (m, c)`` of ``x`` to their
    queries ``q: (m, d)``: the gather-rerank kernel op for L2 (sentinel
    ids are clipped into range; the caller masks them), plain torch for
    L1.  Each distance is summed over ``d`` alone, so it does not depend on
    the batch or the candidates beside it."""
    if metric == "l2":
        return gather_rerank_block(ids, x, q)
    return rowwise_candidate_dist(q, x[ids.clamp(0, x.shape[0] - 1).long()], metric)


def rerank_candidates(
    x: torch.Tensor,
    q: torch.Tensor,
    cand: torch.Tensor,
    cand_scores: torch.Tensor,
    k: int,
    metric: Metric = "l2",
) -> QueryResult:
    """Exact re-rank of an explicit candidate pool (Alg. 1 lines 11-15).

    ``x: (n, d)``, ``q: (m, d)``, ``cand/cand_scores: (m, p)``: per-query
    candidate row ids and their SC-scores.  A slot scoring below 0 (a pool
    sentinel or a deleted row) gets distance ``+inf`` and can never win.
    Distance ties go to the earlier pool position (a stable sort of the
    distances, the ``lax.top_k`` rule), so the same pool in the same order
    gives the same answer.
    """
    if k > cand.shape[1]:
        raise ValueError(f"k={k} exceeds the pool width {cand.shape[1]}")
    d = candidate_dists(x, q.contiguous(), cand, metric)
    d = torch.where(cand_scores < 0, float("inf"), d)
    pos = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return QueryResult(
        cand.gather(1, pos).to(torch.int32), d.gather(1, pos), cand_scores.gather(1, pos)
    )


def rerank(
    x: torch.Tensor,
    q: torch.Tensor,
    scores: torch.Tensor,
    k: int,
    n_candidates: int,
    metric: Metric = "l2",
) -> QueryResult:
    """Paper Alg. 1 lines 11-15: exact re-rank of the top-SC-score pool.

    ``x: (n, d)``, ``q: (m, d)``, ``scores: (m, n)`` int32.  The pool is the
    ``max(k, min(n_candidates, n))`` highest scores, ties to the lower index:
    a stable descending sort of the scores, which is ``lax.top_k``'s order
    and the streaming pool's (score desc, id asc) order.
    """
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k={k} must be <= n={n}")
    p = max(k, min(n_candidates, n))
    vals, cand = torch.sort(scores, dim=1, descending=True, stable=True)
    return rerank_candidates(x, q, cand[:, :p], vals[:, :p], k, metric)


def merge_topk_pool(
    pool_scores: torch.Tensor,
    pool_ids: torch.Tensor,
    blk_scores: torch.Tensor,
    blk_ids: torch.Tensor,
    *,
    smax: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a score block into a carried top pool, keeping the pool size.

    ``pool_*: (m, p)``, ``blk_*: (m, b)`` -> ``(m, p)``: the first ``p``
    entries of the concatenation in (score desc, id asc) order, scores in
    ``[-1, smax]``.  Sentinels ``(-1, INT32_MAX)`` sort after every real
    entry and are expelled as real candidates arrive.  Any partition of a
    row into blocks merges to the dense (score desc, id asc) top ``p``.
    """
    s = torch.cat([pool_scores, blk_scores], dim=-1)
    i = torch.cat([pool_ids, blk_ids], dim=-1)
    pos = _top_positions(s, i, pool_scores.shape[-1], smax)
    return s.gather(-1, pos), i.gather(-1, pos)


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
    s = torch.cat([pool_scores, blk_scores], dim=-1)
    dd = torch.cat([pool_dists, blk_dists], dim=-1)
    i = torch.cat([pool_ids, blk_ids], dim=-1)
    pos = _top_positions(s, i, pool_scores.shape[-1], smax)
    return s.gather(-1, pos), dd.gather(-1, pos), i.gather(-1, pos)


@torch.inference_mode()
def sc_linear_query(
    x: torch.Tensor,
    q: torch.Tensor,
    *,
    spec: subspace.SubspaceSpec,
    k: int,
    alpha: float,
    beta: float,
    metric: Metric = "l2",
) -> QueryResult:
    """Algorithm 1 for a batch of queries ``q: (m, d)`` over ``x: (n, d)``,
    on the device ``x`` lies on.

    Index-free: every point is scored against every query in each of the
    ``Ns`` subspaces (:func:`sc_scores_from_subspaces`), and the
    ``beta * n`` best-scoring points are re-ranked exactly
    (:func:`rerank`).  Returns ``QueryResult`` of ``(m, k)`` ids (int32),
    distances and SC-scores (int32).
    """
    n = x.shape[0]
    x, q = x.float().contiguous(), q.float().contiguous()
    xs = subspace.split_padded(spec, subspace.permute(spec, x))  # (Ns, n, s)
    qs = subspace.split_padded(spec, subspace.permute(spec, q))  # (Ns, m, s)
    scores = sc_scores_from_subspaces(xs, qs, subspace.collision_count(n, alpha), metric)
    return rerank(x, q, scores, k, candidate_pool_size(n, k, beta), metric)
