"""The SC-score ops: each checks its arguments, then dispatches on the
device of the tensors it was given.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel (:mod:`.kernel`), and a failed build or launch raises.  The
JAX package pads every operand to its TPU tiles (padded data rows at a
distance that never collides, padded queries with cut -1 or ``thr =
INT32_MAX``, padded dims of zeros) and slices the padding off again; the
kernels here mask their ragged edges instead, so nothing is padded and the
outputs are the reference's sliced outputs.  Cell ids may be a column
slice of the index's ``(Ns, n)`` cell ids, and subspace vectors views of a
``(n, d)`` array: only their rows need be contiguous.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.sc_score import kernel
from repro_torch.kernels.sc_score.ref import (
    sc_score_cells_prefilter_compact_ref,
    sc_score_cells_prefilter_ref,
    sc_score_cells_ref,
    sc_score_ref,
)

__all__ = [
    "sc_scores_fused",
    "sc_scores_cells",
    "sc_scores_cells_prefilter",
    "sc_scores_cells_prefilter_compact",
]

#: Most query rows of one ``sc_scores_fused`` launch (65,535 tiles of 32).
MAX_FUSED_ROWS = 32 * 65_535


def _check_cells(ranks, cuts, cells) -> tuple[int, int, int, int]:
    ns, m, k_cells = check_tensor("ranks", ranks, torch.int32, 3)
    check_tensor("cuts", cuts, torch.int32, (ns, m))
    _, bc = check_tensor("cells", cells, torch.int32, 2, rows_only=True)
    if cells.shape[0] != ns:
        raise ValueError(f"cells has {cells.shape[0]} rows, expected Ns={ns}")
    if min(m, bc, k_cells) < 1:
        raise ValueError(f"m, bc and K must be >= 1, got {m}/{bc}/{k_cells}")
    return ns, m, k_cells, bc


def sc_scores_fused(
    qs: torch.Tensor,  # (Ns, m, s) float32 per-subspace queries
    xs: torch.Tensor,  # (Ns, n, s) float32 per-subspace data
    tau: torch.Tensor,  # (Ns, m) float32 collision thresholds
) -> torch.Tensor:
    """SC-scores of raw subspace vectors ``-> (m, n)`` int32: the number of
    subspaces ``i`` with ``max(|q_i|^2 + |x_i|^2 - 2 q_i.x_i, 0) <= tau[i]``.
    The distances are :func:`repro_torch.kernels.pairwise_l2.ops.
    pairwise_sqdist`'s, bit for bit, so thresholds taken from those
    distances count exactly their collisions."""
    ns, m, s = check_tensor("qs", qs, torch.float32, 3, rows_only=True)
    n = check_tensor("xs", xs, torch.float32, 3, rows_only=True)[1]
    if xs.shape[0] != ns or xs.shape[2] != s:
        raise ValueError(f"xs must be ({ns}, n, {s}), got {tuple(xs.shape)}")
    check_tensor("tau", tau, torch.float32, (ns, m))
    same_device(qs, xs, tau)
    if min(ns, m, n, s) < 1:
        raise ValueError(f"need Ns, m, n and s >= 1, got {ns}/{m}/{n}/{s}")
    if m > MAX_FUSED_ROWS:
        raise ValueError(f"m={m} exceeds the kernel's {MAX_FUSED_ROWS} query rows")
    if qs.device.type == "cpu":
        return sc_score_ref(qs, xs, tau)
    if qs.device.type == "cuda":
        return kernel.sc_score_fused(qs, xs, tau)
    raise ValueError(f"no sc_score route for device {qs.device}")


def sc_scores_cells(
    ranks: torch.Tensor,  # (Ns, m, K) int32 per-(subspace, query) cell ranks
    cuts: torch.Tensor,  # (Ns, m) int32 activation cutoff ranks
    cells: torch.Tensor,  # (Ns, bc) int32 chunk cell ids (rows may be strided)
) -> torch.Tensor:
    """Chunked SuCo collision scores ``-> (m, bc)`` int32: point j collides
    with query q in subspace i iff ``ranks[i, q, cells[i, j]] <= cuts[i, q]``."""
    _check_cells(ranks, cuts, cells)
    dev = same_device(ranks, cuts, cells)
    if dev.type == "cpu":
        return sc_score_cells_ref(ranks, cuts, cells)
    if dev.type == "cuda":
        return kernel.sc_score_cells(ranks, cuts, cells)
    raise ValueError(f"no sc_score_cells route for device {dev}")


def sc_scores_cells_prefilter(
    ranks: torch.Tensor,  # (Ns, m, K) int32 per-(subspace, query) cell ranks
    cuts: torch.Tensor,  # (Ns, m) int32 activation cutoff ranks
    cells: torch.Tensor,  # (Ns, bc) int32 chunk cell ids (rows may be strided)
    thr: torch.Tensor,  # (m,) int32 carried pool minimum score per query
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sc_scores_cells` plus the Pareto prefilter ``-> (scores (m, bc)
    int32, keep (m, bc) bool)`` with ``keep = scores > thr[:, None]``,
    written in the same pass.  The caller masks columns past the end of
    the data, which this op cannot know about."""
    m = _check_cells(ranks, cuts, cells)[1]
    check_tensor("thr", thr, torch.int32, (m,))
    dev = same_device(ranks, cuts, cells, thr)
    if dev.type == "cpu":
        return sc_score_cells_prefilter_ref(ranks, cuts, cells, thr)
    if dev.type == "cuda":
        return kernel.sc_score_cells_prefilter(ranks, cuts, cells, thr)
    raise ValueError(f"no sc_score_cells_prefilter route for device {dev}")


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
    _, m, _, bc = _check_cells(ranks, cuts, cells)
    check_tensor("thr", thr, torch.int32, (m,))
    if keep_cols is not None:
        check_tensor("keep_cols", keep_cols, torch.bool, (bc,))
    same_device(ranks, cuts, cells, thr, keep_cols)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    limit = int(limit)
    if ranks.device.type == "cpu":
        return sc_score_cells_prefilter_compact_ref(
            ranks, cuts, cells, thr, limit, keep_cols, cap=cap
        )
    if ranks.device.type == "cuda":
        return kernel.sc_score_compact(ranks, cuts, cells, thr, limit, keep_cols, cap)
    raise ValueError(f"no sc_score route for device {ranks.device}")
