"""Launches of the SC-score CUDA kernels.

``csrc/sc_score.cu`` replaces the TPU kernels ``sc_score_cells_kernel``,
``sc_score_cells_prefilter_kernel`` and
``sc_score_cells_prefilter_compact_kernel``: a block per query (and, for
the first two, per 32,768 columns), the activated set as a bitmap in shared
memory, and for the compaction a block-wide scan for the survivor slots.
Bytes bound them on an H100.  ``sc_score_fused`` of ``csrc/pairwise_l2.cu``
replaces ``sc_score_kernel``: SIMT distance tiles, counted over the
subspaces in registers; operations bound it.  (See the sources' headers.)

The op wrappers (:mod:`.ops`) have checked every argument; this module
allocates the outputs, launches on the current stream and raises on any
CUDA error.  ``launches`` (the compact kernel), ``cells_launches``,
``prefilter_launches`` and ``fused_launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
cells_launches = 0
prefilter_launches = 0
fused_launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_CELLS_ARGTYPES = [_P, _P, _P, _LL, _I, _I, _I, _I, _P, _P]
_PREFILTER_ARGTYPES = [_P, _P, _P, _LL, _P, _I, _I, _I, _I, _P, _P, _P]
_FUSED_ARGTYPES = [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _I, _P, _P]


def sc_score_cells(ranks: torch.Tensor, cuts: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    global cells_launches
    ns, m, k_cells = ranks.shape
    bc = cells.shape[1]
    dev = ranks.device
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_cells", _CELLS_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0),
            ns, m, k_cells, bc, scores.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("sc_score", rc, "sc_score_cells")
    cells_launches += 1
    return scores


def sc_score_cells_prefilter(
    ranks: torch.Tensor, cuts: torch.Tensor, cells: torch.Tensor, thr: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    global prefilter_launches
    ns, m, k_cells = ranks.shape
    bc = cells.shape[1]
    dev = ranks.device
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    keep = torch.empty((m, bc), dtype=torch.bool, device=dev)  # one byte, written 0 / 1
    fn = _build.entry("sc_score", "sc_score_cells_prefilter", _PREFILTER_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0), thr.data_ptr(),
            ns, m, k_cells, bc, scores.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("sc_score", rc, "sc_score_cells_prefilter")
    prefilter_launches += 1
    return scores, keep


def sc_score_fused(qs: torch.Tensor, xs: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    global fused_launches
    ns, m, s = qs.shape
    n = xs.shape[1]
    dev = qs.device
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    fn = _build.entry("pairwise_l2", "sc_score_fused", _FUSED_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            qs.data_ptr(), qs.stride(0), qs.stride(1), xs.data_ptr(), xs.stride(0), xs.stride(1),
            tau.data_ptr(), ns, m, n, s, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("pairwise_l2", rc, "sc_score_fused")
    fused_launches += 1
    return out


def sc_score_compact(
    ranks: torch.Tensor,
    cuts: torch.Tensor,
    cells: torch.Tensor,
    thr: torch.Tensor,
    limit: int,
    keep_cols: torch.Tensor | None,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    ns, m, k_cells = ranks.shape
    bc = cells.shape[1]
    dev = ranks.device
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    surv_cols = torch.empty((m, cap), dtype=torch.int32, device=dev)
    surv_scores = torch.empty((m, cap), dtype=torch.int32, device=dev)
    count = torch.empty((m,), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0),
            thr.data_ptr(), None if keep_cols is None else keep_cols.data_ptr(),
            ns, m, k_cells, bc, limit, cap,
            scores.data_ptr(), surv_cols.data_ptr(), surv_scores.data_ptr(),
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("sc_score", rc, "sc_score_compact")
    launches += 1
    return scores, surv_cols, surv_scores, count
