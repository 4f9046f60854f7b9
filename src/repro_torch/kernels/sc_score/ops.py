"""The fused SC-score chunk stage: checks its arguments, then dispatches on
the device of the tensors it was given.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel (:mod:`.kernel`), and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.sc_score import kernel
from repro_torch.kernels.sc_score.ref import sc_score_cells_prefilter_compact_ref

__all__ = ["sc_scores_cells_prefilter_compact"]


def sc_scores_cells_prefilter_compact(
    ranks: torch.Tensor,  # (Ns, m, K) int32 per-(subspace, query) cell ranks
    cuts: torch.Tensor,  # (Ns, m) int32 activation cutoff ranks
    cells: torch.Tensor,  # (Ns, bc) int32 chunk cell ids (rows may be strided)
    thr: torch.Tensor,  # (m,) int32 carried pool minimum score per query
    limit: int,  # count of valid chunk columns
    keep_cols: torch.Tensor | None = None,  # (bc,) bool live-column mask
    *,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of the fused query: ``-> (scores (m, bc), surv_cols
    (m, cap), surv_scores (m, cap), count (m,))``, all int32.

    Scores of columns ``>= limit`` or dead in ``keep_cols`` are -1; the
    columns scoring above ``thr`` are compacted in ascending order into
    ``cap`` slots (column 0 / score -1 in empty slots); ``count`` is the true
    survivor count and may exceed ``cap``.  ``cells`` may be a column slice
    of the index's ``(Ns, n)`` cell ids: its rows need only be contiguous.
    """
    ns, m, _ = check_tensor("ranks", ranks, torch.int32, 3)
    check_tensor("cuts", cuts, torch.int32, (ns, m))
    _, bc = check_tensor("cells", cells, torch.int32, 2, rows_only=True)
    if cells.shape[0] != ns:
        raise ValueError(f"cells has {cells.shape[0]} rows, expected Ns={ns}")
    check_tensor("thr", thr, torch.int32, (m,))
    if keep_cols is not None:
        check_tensor("keep_cols", keep_cols, torch.bool, (bc,))
    same_device(ranks, cuts, cells, thr, keep_cols)
    if min(m, bc) < 1 or cap < 1:
        raise ValueError(f"m, bc and cap must be >= 1, got {m}/{bc}/{cap}")
    limit = int(limit)
    if ranks.device.type == "cpu":
        return sc_score_cells_prefilter_compact_ref(
            ranks, cuts, cells, thr, limit, keep_cols, cap=cap
        )
    if ranks.device.type == "cuda":
        return kernel.sc_score_compact(ranks, cuts, cells, thr, limit, keep_cols, cap)
    raise ValueError(f"no sc_score route for device {ranks.device}")
