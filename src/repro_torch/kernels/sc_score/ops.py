"""The SC-score ops: each checks its arguments, then dispatches on the
device of the tensors it was given.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel (:mod:`.kernel`), and a failed build or launch raises: each op
calls one operator ``torch.ops.repro_torch.<op>``, which dispatches by
device (:mod:`repro_torch.kernels._library`).  The
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

from repro_torch.kernels import _library
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

#: Most query rows and points of one ``sc_scores_fused`` launch: a block's
#: 64 query rows and 128 points keep C ``int`` indices (the source's
#: ``kMaxRows``, ``kMaxPoints``).
MAX_FUSED_ROWS = 2**31 - kernel.FUSED_QUERIES
MAX_FUSED_POINTS = 2**31 - kernel.FUSED_POINTS
#: Most blocks of one launch, one a work item (:func:`kernel.fused_blocks`):
#: its grid's x extent.
MAX_FUSED_BLOCKS = 2**31 - 1


def _empty(like: torch.Tensor, shape, dtype=torch.int32) -> torch.Tensor:
    return like.new_empty(shape, dtype=dtype)


def _fused_cpu(qs, xs, tau):
    return sc_score_ref(qs, xs, tau)


def _fused_cuda(qs, xs, tau):
    return kernel.sc_score_fused(qs, xs, tau)


def _fused_meta(qs, xs, tau):
    return _empty(qs, (qs.shape[1], xs.shape[1]))


def _cells_cpu(ranks, cuts, cells):
    return sc_score_cells_ref(ranks, cuts, cells)


def _cells_cuda(ranks, cuts, cells):
    return kernel.sc_score_cells(ranks, cuts, cells)


def _cells_meta(ranks, cuts, cells):
    return _empty(ranks, (ranks.shape[1], cells.shape[1]))


def _prefilter_cpu(ranks, cuts, cells, thr):
    return sc_score_cells_prefilter_ref(ranks, cuts, cells, thr)


def _prefilter_cuda(ranks, cuts, cells, thr):
    return kernel.sc_score_cells_prefilter(ranks, cuts, cells, thr)


def _prefilter_meta(ranks, cuts, cells, thr):
    shape = (ranks.shape[1], cells.shape[1])
    return _empty(ranks, shape), _empty(ranks, shape, torch.bool)


def _compact_cpu(ranks, cuts, cells, thr, limit, keep_cols, cap):
    return sc_score_cells_prefilter_compact_ref(ranks, cuts, cells, thr, limit, keep_cols, cap=cap)


def _compact_cuda(ranks, cuts, cells, thr, limit, keep_cols, cap):
    return kernel.sc_score_compact(ranks, cuts, cells, thr, limit, keep_cols, cap)


def _compact_meta(ranks, cuts, cells, thr, limit, keep_cols, cap):
    m = ranks.shape[1]
    return (_empty(ranks, (m, cells.shape[1])), _empty(ranks, (m, cap)),
            _empty(ranks, (m, cap)), _empty(ranks, (m,)))


_FUSED = _library.define(
    "sc_scores_fused(Tensor qs, Tensor xs, Tensor tau) -> Tensor",
    cpu=_fused_cpu, cuda=_fused_cuda, meta=_fused_meta,
)
_CELLS = _library.define(
    "sc_scores_cells(Tensor ranks, Tensor cuts, Tensor cells) -> Tensor",
    cpu=_cells_cpu, cuda=_cells_cuda, meta=_cells_meta,
)
_PREFILTER = _library.define(
    "sc_scores_cells_prefilter(Tensor ranks, Tensor cuts, Tensor cells, Tensor thr)"
    " -> (Tensor, Tensor)",
    cpu=_prefilter_cpu, cuda=_prefilter_cuda, meta=_prefilter_meta,
)
_COMPACT = _library.define(
    "sc_scores_cells_prefilter_compact(Tensor ranks, Tensor cuts, Tensor cells, Tensor thr,"
    " int limit, Tensor? keep_cols, int cap) -> (Tensor, Tensor, Tensor, Tensor)",
    cpu=_compact_cpu, cuda=_compact_cuda, meta=_compact_meta,
)


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
    if n > MAX_FUSED_POINTS:
        raise ValueError(f"n={n} exceeds the kernel's {MAX_FUSED_POINTS} points")
    if kernel.fused_blocks(m, n) > MAX_FUSED_BLOCKS:
        raise ValueError(f"m={m} x n={n} exceeds the kernel's {MAX_FUSED_BLOCKS} blocks "
                         f"of {kernel.FUSED_QUERIES} x {kernel.FUSED_POINTS}")
    _library.route(qs.device, "sc_score")
    return _FUSED(qs, xs, tau)


def sc_scores_cells(
    ranks: torch.Tensor,  # (Ns, m, K) int32 per-(subspace, query) cell ranks
    cuts: torch.Tensor,  # (Ns, m) int32 activation cutoff ranks
    cells: torch.Tensor,  # (Ns, bc) int32 chunk cell ids (rows may be strided)
) -> torch.Tensor:
    """Chunked SuCo collision scores ``-> (m, bc)`` int32: point j collides
    with query q in subspace i iff ``ranks[i, q, cells[i, j]] <= cuts[i, q]``."""
    _check_cells(ranks, cuts, cells)
    _library.route(same_device(ranks, cuts, cells), "sc_score_cells")
    return _CELLS(ranks, cuts, cells)


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
    _library.route(same_device(ranks, cuts, cells, thr), "sc_score_cells_prefilter")
    return _PREFILTER(ranks, cuts, cells, thr)


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
    _library.route(ranks.device, "sc_score")
    return _COMPACT(ranks, cuts, cells, thr, int(limit), keep_cols, cap)


# --------------------------------------------------------------------------
# Static-gate registry hook (see repro_torch.analysis)
# --------------------------------------------------------------------------

#: The gate's shapes, the JAX package's: (Ns, m, K, chunk, subspace width).
_LINT_NS, _LINT_M, _LINT_K, _LINT_BC, _LINT_S = 4, 8, 2_560, 512, 128


def lint_entries():
    from repro_torch.analysis.registry import TileEntry, TraceEntry
    from repro_torch.analysis.trace_rules import trace
    from repro_torch.core.spans import loop_span

    ns, m, k_cells, bc, s = _LINT_NS, _LINT_M, _LINT_K, _LINT_BC, _LINT_S

    def inputs(chunks: int = 1):
        g = torch.Generator().manual_seed(0)
        ranks = torch.randint(0, k_cells, (ns, m, k_cells), generator=g, dtype=torch.int32)
        cuts = torch.randint(0, k_cells // 4, (ns, m), generator=g, dtype=torch.int32)
        cells = torch.randint(0, k_cells, (ns, chunks * bc), generator=g, dtype=torch.int32)
        thr = torch.randint(-1, ns, (m,), generator=g, dtype=torch.int32)
        return ranks, cuts, cells, thr

    def make_cells():
        ranks, cuts, cells, _ = inputs()
        return trace(sc_scores_cells, ranks, cuts, cells)

    def make_prefilter():
        ranks, cuts, cells, thr = inputs()
        return trace(sc_scores_cells_prefilter, ranks, cuts, cells, thr)

    def make_compact():
        ranks, cuts, cells, thr = inputs()
        return trace(sc_scores_cells_prefilter_compact, ranks, cuts, cells, thr, bc, cap=128)

    def make_compact_scan():
        # the compact op as the fused query runs it: once a chunk, in a loop
        def run():
            ranks, cuts, cells, thr = inputs(chunks=4)
            for lo in range(0, 4 * bc, bc):
                with loop_span("kernels.sc_score.chunk"):
                    sc_scores_cells_prefilter_compact(ranks, cuts, cells[:, lo:lo + bc], thr, bc,
                                                      cap=128)
        return trace(run)

    def make_fused():
        g = torch.Generator().manual_seed(1)
        qs, xs = torch.randn((ns, m, s), generator=g), torch.randn((ns, 1_024, s), generator=g)
        return trace(sc_scores_fused, qs, xs, torch.full((ns, m), float(s)))

    def make_oracle():
        ranks, cuts, cells, _ = inputs()
        return trace(sc_score_cells_ref, ranks, cuts, cells)

    return [
        TileEntry(name="kernels.sc_score.cells", contract={}, make=make_cells,
                  note="chunk scores: the bitmap pass and the sweep"),
        TileEntry(name="kernels.sc_score.cells_prefilter", contract={}, make=make_prefilter,
                  note="chunk scores and the Pareto keep mask in one sweep"),
        TileEntry(name="kernels.sc_score.cells_prefilter_compact", contract={}, make=make_compact,
                  note="one chunk of the fused query: scores, survivor counts, compaction"),
        TraceEntry(
            name="kernels.sc_score.prefilter_compact_scan", make=make_compact_scan,
            rules=("no-scatter-in-scan", "pinned-accumulator"),
            note="the compact op inside a chunk loop: one operator a chunk, no sort or scatter",
        ),
        TileEntry(name="kernels.sc_score.fused_distance", contract={}, make=make_fused,
                  note="SC-Linear's scorer: 3xTF32 screen and plain re-checks"),
        TraceEntry(
            name="kernels.sc_score.oracle", make=make_oracle,
            rules=("bounded-intermediate", "pinned-accumulator"),
            budget_bytes=4 * 2 * ns * m * max(k_cells, bc),
            note="the plain version of the chunk scorer (the CPU path)",
        ),
    ]
