"""Plain PyTorch versions of the SC-score kernels.

The port's counterpart of ``repro.kernels.sc_score.ref``: the chunked IMI
scores, with the keep mask, with the prefilter and compaction, and the
SC-scores of raw subspace vectors against their thresholds.  They are what
a CPU tensor runs, and what the CUDA kernels are held against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_l2.ref import pairwise_sqdist_ref


def sc_score_cells_ref(
    ranks: torch.Tensor, cuts: torch.Tensor, cells: torch.Tensor
) -> torch.Tensor:
    """``ranks: (Ns,m,K), cuts: (Ns,m), cells: (Ns,bc) -> (m,bc)`` int32:
    point j collides with query q in subspace i iff the rank of its cell is
    within the activation cutoff."""
    ns, m, _ = ranks.shape
    idx = cells.long()[:, None, :].expand(ns, m, cells.shape[1])
    g = torch.gather(ranks, 2, idx)  # (Ns, m, bc)
    return (g <= cuts[:, :, None]).sum(dim=0, dtype=torch.int32)


def sc_score_cells_prefilter_ref(
    ranks: torch.Tensor, cuts: torch.Tensor, cells: torch.Tensor, thr: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk scores plus ``keep = scores > thr[:, None]``: the rows that
    could enter a top pool whose minimum score is ``thr``."""
    s = sc_score_cells_ref(ranks, cuts, cells)
    return s, s > thr[:, None]


def sc_score_cells_prefilter_compact_ref(
    ranks: torch.Tensor,
    cuts: torch.Tensor,
    cells: torch.Tensor,
    thr: torch.Tensor,
    limit: int,
    keep_cols: torch.Tensor | None = None,
    *,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score + prefilter + survivor compaction of one chunk.

    Columns at or past ``limit``, and columns False in ``keep_cols`` (the
    tombstone mask), score -1 and can never survive.  Returns ``(scores
    (m, bc), surv_cols (m, cap), surv_scores (m, cap), count (m,))``, all
    int32: the j-th column with ``score > thr[q]`` in ascending order sits
    at slot j, empty slots hold column 0 / score -1, and ``count`` is the
    true number of survivors (it may exceed ``cap``).  The compaction is a
    binary search on the keep mask's running count, as in the oracle.
    """
    bc = cells.shape[1]
    s = sc_score_cells_ref(ranks, cuts, cells)
    col = torch.arange(bc, device=s.device)
    ok = col < limit
    if keep_cols is not None:
        ok = ok & keep_cols
    s = torch.where(ok[None, :], s, -1)
    keep = s > thr[:, None]
    cnt = torch.cumsum(keep, dim=1, dtype=torch.int32)
    slot = torch.arange(cap, dtype=torch.int32, device=s.device)
    target = (slot + 1)[None, :].expand(s.shape[0], cap).contiguous()
    surv = torch.searchsorted(cnt, target, side="left").clamp_max(bc - 1)
    total = cnt[:, -1]
    live = slot[None, :] < total[:, None]
    surv_cols = torch.where(live, surv.to(torch.int32), 0)
    surv_scores = torch.where(live, s.gather(1, surv), -1)
    return s, surv_cols, surv_scores, total


def sc_score_ref(qs: torch.Tensor, xs: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``qs: (Ns,m,s), xs: (Ns,n,s), tau: (Ns,m) -> (m,n)`` int32: the number
    of subspaces in which each point lies within the query's threshold.
    Each subspace's distances are :func:`pairwise_sqdist_ref`'s, the
    arithmetic of the kernel."""
    out = torch.zeros((qs.shape[1], xs.shape[1]), dtype=torch.int32, device=qs.device)
    for i in range(qs.shape[0]):
        out += pairwise_sqdist_ref(qs[i], xs[i]) <= tau[i][:, None]
    return out
