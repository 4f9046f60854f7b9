"""SC-Linear (paper Algorithm 1) and the candidate pools of the SC
framework: result type, pool width, the exact rerank, and the exact
(score desc, id asc) pool merges of the streaming and fused queries.

The counterpart of ``repro.core.sc_linear``.  The JAX package selects with
``lax.top_k``, whose ties go to the lower position; ``torch.topk``
promises no order among ties on the card, so every selection here is a
stable sort instead (of the scores, or of a composite int64 key): one exact
order, the same on every device.

The pool merges take the JAX package's ``impl`` names.  ``"topk"`` and
``"sort"`` are one route here, a stable sort of the (score desc, id asc)
key.  ``"counting"`` is the reference's sort-free merge for integer scores
in ``[-1, smax]``: the block ordered by a counting pass per score level
(:func:`_counting_sort_block`), then merged with the score-descending pool
by binary searches (:func:`_merge_sorted_desc`), with no sort and no
scatter.  ``"auto"`` resolves to ``"counting"`` for integer scores with a
``smax``.  Every impl gives the same bits on the pools the query paths
build: blocks in ascending id order, every pool id below every block id.
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
    "MERGE_IMPLS",
    "sc_linear_query",
]

INT32_MAX = 2**31 - 1
#: the bound the sort route's key takes when a merge is given no ``smax``:
#: any score in ``[-1, INT32_MAX - 1]`` keeps the key within int64
_KEY_SMAX = INT32_MAX - 1
MERGE_IMPLS = ("topk", "sort", "counting", "auto")


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


def _counting_sort_block(blk_scores: torch.Tensor, smax: int, p_out: int) -> torch.Tensor:
    """Columns of the top ``p_out`` entries of each block row in (score
    desc, position asc) order, without a sort or a scatter.

    Scores lie in ``[-1, smax]`` (the sentinel -1 and the SC-scores), so a
    pass per score level, highest first, gives each level's running count
    (a ``cumsum``), its first output slot (the counts of the levels above)
    and, for the r-th slot of a level, the first column whose running
    count reaches r + 1 (a binary search of the monotone count).  The
    reference's ``_counting_sort_block``, op for op.  Scores outside the
    range are dropped.
    """
    m, bw = blk_scores.shape
    dev = blk_scores.device
    sv = blk_scores.to(torch.int32) + 1  # the sentinel -1 -> level 0
    u = torch.arange(p_out, dtype=torch.int32, device=dev)
    src = torch.zeros((m, p_out), dtype=torch.int32, device=dev)
    start = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    for b in range(smax + 1, -1, -1):  # the highest level fills slots first
        pref = torch.cumsum((sv == b).to(torch.int32), dim=-1, dtype=torch.int32)
        hist = pref[:, -1:]
        r = u[None, :] - start  # the rank within level b, if slot u is b's
        in_b = (r >= 0) & (r < hist)
        pos = torch.searchsorted(pref, torch.clamp(r + 1, 1, bw), out_int32=True)
        src = torch.where(in_b, pos, src)
        start = start + hist
    return src


def _merge_sorted_desc(
    a_s: torch.Tensor, b_s: torch.Tensor, p: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first ``p`` slots of the stable merge of two score-descending
    rows ``a_s: (m, pa)`` and ``b_s: (m, pb)`` (A before B on equal
    scores), inverted without a scatter: A_i lands at ``i + #{B > A_i}`` and
    B_j at ``j + #{A >= B_j}``, both increasing, so a binary search maps
    each output slot to its source.  Returns ``(is_a, i_a, i_b)``: slot t
    takes ``A[i_a]`` where ``is_a``, else ``B[i_b]``."""
    m, pa = a_s.shape
    pb = b_s.shape[1]
    dev = a_s.device
    t = torch.arange(p, dtype=torch.int32, device=dev)
    na, nb = (-a_s).contiguous(), (-b_s).contiguous()  # ascending, as the searches need
    cnt_a = torch.searchsorted(na, nb, right=True, out_int32=True)  # per B_j: #A >= B_j
    cnt_b = torch.searchsorted(nb, na, out_int32=True)  # per A_i: #B > A_i
    pos_a = torch.arange(pa, dtype=torch.int32, device=dev)[None, :] + cnt_b
    pos_b = torch.arange(pb, dtype=torch.int32, device=dev)[None, :] + cnt_a
    tt = t[None, :].expand(m, p).contiguous()
    i_a = torch.clamp(torch.searchsorted(pos_a, tt, out_int32=True), max=pa - 1)
    i_b = torch.clamp(torch.searchsorted(pos_b, tt, out_int32=True), max=pb - 1)
    is_a = pos_a.gather(1, i_a.long()) == t[None, :]
    return is_a, i_a, i_b


def _counting_merge(
    pool: tuple[torch.Tensor, ...], blk: tuple[torch.Tensor, ...], smax: int
) -> tuple[torch.Tensor, ...]:
    """The counting merge: order the block by counting, then invert the
    sorted merge with the pool.  ``pool[0]`` / ``blk[0]`` are the scores;
    the other tensors (ids, distances) ride through the same gathers."""
    p, bw = pool[0].shape[-1], blk[0].shape[-1]
    # only the block's top min(p, bw) can enter a p-wide pool
    src = _counting_sort_block(blk[0], smax, min(p, bw)).long()
    blk_sorted = tuple(a.gather(1, src) for a in blk)
    is_a, i_a, i_b = _merge_sorted_desc(pool[0], blk_sorted[0], p)
    i_a, i_b = i_a.long(), i_b.long()
    return tuple(
        torch.where(is_a, pa.gather(1, i_a), ba.gather(1, i_b))
        for pa, ba in zip(pool, blk_sorted)
    )


def _resolve_merge_impl(impl: str, score_dtype: torch.dtype, smax: int | None) -> str:
    """``"auto"`` is ``"counting"`` exactly when the scores are integers with
    a ``smax``, else ``"topk"``; ``"counting"`` needs both."""
    if impl not in MERGE_IMPLS:
        raise ValueError(f"impl must be one of {MERGE_IMPLS}, got {impl!r}")
    integer = not (score_dtype.is_floating_point or score_dtype.is_complex
                   or score_dtype == torch.bool)
    if impl == "auto":
        return "counting" if (smax is not None and integer) else "topk"
    if impl == "counting":
        if smax is None:
            raise ValueError(
                "impl='counting' needs smax (the maximum score, e.g. n_subspaces for SC-scores)"
            )
        if not integer:
            raise ValueError(f"impl='counting' requires integer scores, got {score_dtype}")
    return impl


def top_block_positions(
    s: torch.Tensor, ids: torch.Tensor, p: int, smax: int, impl: str
) -> torch.Tensor:
    """Positions of the top ``p`` entries of each row of a block whose ids
    ascend along the row, in (score desc, id asc) order: by counting for
    ``"counting"``, else the stable sort of the key."""
    if _resolve_merge_impl(impl, s.dtype, smax) == "counting":
        return _counting_sort_block(s, smax, p).long()
    return _top_positions(s, ids, p, smax)


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
    impl: str = "topk",
    smax: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a score block into a carried top pool, keeping the pool size.

    ``pool_*: (m, p)``, ``blk_*: (m, b)`` -> ``(m, p)``: the first ``p``
    entries of the concatenation in (score desc, id asc) order, scores in
    ``[-1, smax]``.  Sentinels ``(-1, INT32_MAX)`` sort after every real
    entry and are expelled as real candidates arrive.  Any partition of a
    row into blocks merges to the dense (score desc, id asc) top ``p``.

    ``impl`` (:data:`MERGE_IMPLS`): ``"topk"`` and ``"sort"`` take the
    stable sort of the key; ``"counting"`` (``smax`` and integer scores
    required) the reference's counting merge, which breaks ties by position
    (pool first, then the block's order), so it equals the sort route when
    the block ascends in id and every pool id is below it, as on the query
    paths, and equals the reference's ``"counting"`` and ``"topk"`` on any
    block whose pool is score-descending; ``"auto"`` is counting for integer
    scores with a ``smax``.
    """
    impl = _resolve_merge_impl(impl, pool_scores.dtype, smax)
    if impl == "counting":
        return _counting_merge((pool_scores, pool_ids), (blk_scores, blk_ids), smax)
    smax = _KEY_SMAX if smax is None else smax
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
    impl: str = "topk",
    smax: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge a ``(score, dist, id)`` block into the carried top pool.

    ``pool_*: (m, p)``, ``blk_*: (m, b)`` -> three ``(m, p)`` tensors: the
    first ``p`` entries of the concatenation in (score desc, id asc) order.
    Entries equal in both keys (only the ``(-1, INT32_MAX, +inf)``
    sentinels) keep their concatenated order — the stable sort — which is
    also ``lax.top_k``'s rule, so the pool equals the JAX package's for
    every ``merge_impl``.  Distances ride along and take no part in the
    selection.  ``impl`` as :func:`merge_topk_pool`.
    """
    impl = _resolve_merge_impl(impl, pool_scores.dtype, smax)
    if impl == "counting":
        s, i, dd = _counting_merge(
            (pool_scores, pool_ids, pool_dists), (blk_scores, blk_ids, blk_dists), smax
        )
        return s, dd, i
    smax = _KEY_SMAX if smax is None else smax
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


# --------------------------------------------------------------------------
# Static-gate registry hook (see repro_torch.analysis)
# --------------------------------------------------------------------------


def lint_entries():
    """Registry hook: the index-free baseline and the pool-merge loops, at
    the JAX package's shapes."""
    from repro_torch.analysis.registry import TraceEntry
    from repro_torch.analysis.trace_rules import trace
    from repro_torch.core.spans import loop_span

    n, d, m, k = 4_096, 32, 8, 10
    alpha, beta = 0.05, 0.05
    spec = subspace.contiguous_spec(d, 8)
    pool = candidate_pool_size(n, k, beta)
    mq, p, bn, blocks = 8, 64, 128, 4

    def make_query():
        g = torch.Generator().manual_seed(0)
        x, q = torch.randn((n, d), generator=g), torch.randn((m, d), generator=g)
        return trace(sc_linear_query, x, q, spec=spec, k=k, alpha=alpha, beta=beta)

    def blocks_of(g: torch.Generator, smax: int):
        # ascending-id blocks, as the query paths merge them
        scores = torch.randint(-1, smax + 1, (blocks, mq, bn), generator=g, dtype=torch.int32)
        ids = torch.arange(blocks * bn, dtype=torch.int32).reshape(blocks, 1, bn).expand(
            blocks, mq, bn)
        return scores, ids

    def make_merge_scan(impl: str = "topk", smax: int = 8):
        def run():
            scores, ids = blocks_of(torch.Generator().manual_seed(1), smax)
            carry = (torch.full((mq, p), -1, dtype=torch.int32),
                     torch.full((mq, p), INT32_MAX, dtype=torch.int32))
            for b in range(blocks):
                with loop_span("sc_linear.merge_block"):
                    carry = merge_topk_pool(*carry, scores[b], ids[b], impl=impl, smax=smax)
        return lambda: trace(run)

    def make_merge_with_dists_scan(impl: str = "auto", smax: int = 8):
        def run():
            g = torch.Generator().manual_seed(2)
            scores, ids = blocks_of(g, smax)
            dists = torch.rand((blocks, mq, bn), generator=g)
            carry = (torch.full((mq, p), -1, dtype=torch.int32),
                     torch.full((mq, p), float("inf")),
                     torch.full((mq, p), INT32_MAX, dtype=torch.int32))
            for b in range(blocks):
                with loop_span("sc_linear.merge_block"):
                    carry = merge_topk_pool_with_dists(*carry, scores[b], dists[b], ids[b],
                                                       impl=impl, smax=smax)
        return lambda: trace(run)

    merge_rules = ("no-scatter-in-scan", "pinned-accumulator")
    return [
        TraceEntry(
            name="sc_linear.query", make=make_query,
            rules=("bounded-intermediate", "pinned-accumulator"),
            # one (m, n) distance block per subspace, the (Ns, n, s) split
            # views (O(n d)) and the rerank's gather
            budget_bytes=4 * max(2 * m * n, 2 * n * d, m * pool * d),
            note=("Algorithm 1; its subspace loop selects each threshold by a sort by "
                  "design, so no-scatter-in-scan is not declared"),
        ),
        TraceEntry(
            name="sc_linear.merge_pool_scan", make=make_merge_scan(), rules=merge_rules,
            suppress={"no-scatter-in-scan": (
                "impl='topk' is the port's stable sort of the (score desc, id asc) key: "
                "torch.topk leaves the order of ties unspecified on the card; the counting "
                "merge is the sort-free route (sc_linear.merge_pool_counting_scan)")},
            note="the carried top-pool merge of the streaming loops, impl='topk'",
        ),
        TraceEntry(
            name="sc_linear.merge_pool_counting_scan", make=make_merge_scan("counting"),
            rules=merge_rules,
            note=("the counting merge: a cumsum per score level and binary searches, "
                  "no sort and no scatter in the loop"),
        ),
        TraceEntry(
            name="sc_linear.merge_pool_with_dists_scan", make=make_merge_with_dists_scan(),
            rules=merge_rules,
            note="the fused loop's (score, dist, id) merge, impl='auto' (counting)",
        ),
    ]
