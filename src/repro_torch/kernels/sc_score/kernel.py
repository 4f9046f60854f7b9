"""Launches of the SC-score CUDA kernels.

``csrc/sc_score.cu`` replaces the TPU kernels ``sc_score_cells_kernel``,
``sc_score_cells_prefilter_kernel`` and
``sc_score_cells_prefilter_compact_kernel``.  The first two are two
launches from one C entry point: a bitmap pass that reads the ranks once
into device memory (the activated sets, Q queries' bits side by side), then
a sweep in which a block serves Q queries and a tile of columns from that
bitmap in shared memory.  :func:`tiling` picks Q and the tile from one
query's bitmap bytes (the source's ``sc_score_smem_bytes``), the card's
shared memory and its SM count.  The compaction is a block per query, the
activated set as a bitmap in shared memory and a block-wide scan for the
survivor slots.  Bytes bound them on an H100.  ``sc_score_fused`` of
``csrc/pairwise_l2.cu`` replaces ``sc_score_kernel``: SIMT distance tiles,
counted over the subspaces in registers; operations bound it.  (See the
sources' headers.)

The op wrappers (:mod:`.ops`) have checked every argument; this module
allocates the outputs and scratch, launches on the current stream and
raises on any CUDA error.  ``launches`` (the compact kernel),
``cells_launches``, ``prefilter_launches`` and ``fused_launches`` count the
launches (one for the two passes of rows 7 and 8).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0
cells_launches = 0
prefilter_launches = 0
fused_launches = 0

QUERY_TILES = (16, 8, 4, 2, 1)  # queries a sweep block may serve (Q), widest first
MAX_TILE = 2048  # columns of a sweep block at most: 256 threads x 8
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_CELLS_ARGTYPES = [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _P]
_PREFILTER_ARGTYPES = [_P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
_FUSED_ARGTYPES = [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _I, _P, _P]


def tiling(bitmap_bytes: int, smem_limit: int, n_sm: int, m: int, bc: int) -> tuple[int, int]:
    """``(Q, tile)`` of the chunk-score sweep: a block serves ``Q`` queries
    (whose bitmaps take ``Q * bitmap_bytes`` of shared memory, one query's
    being ``bitmap_bytes``) and ``tile`` columns.  ``Q`` is the widest of
    :data:`QUERY_TILES` that fits in ``smem_limit`` and is no wider than
    ``m`` rounded up to a power of two; ``tile`` (at most :data:`MAX_TILE`)
    gives the launch at least two blocks on each of ``n_sm`` SMs wherever
    ``bc`` has that many columns for each group of ``Q`` queries.  Raises
    where one query's bitmap does not fit."""
    if bitmap_bytes > smem_limit:
        raise ValueError(
            f"one query's bitmap takes {bitmap_bytes} bytes of shared memory, more than the "
            f"{smem_limit} a block may use")
    q = next(q for q in QUERY_TILES if q * bitmap_bytes <= smem_limit and (q < 2 * m or q == 1))
    tiles = -(-2 * n_sm // -(-m // q))  # column tiles for two blocks an SM
    return q, min(MAX_TILE, max(1, bc // tiles))


def smem_bytes(ns: int, k_cells: int, q: int) -> int:
    """Shared memory of a sweep block serving ``q`` queries, in bytes, as the
    source lays it out (at most 2^31 - 1); builds the library if needed."""
    return _build.entry("sc_score", "sc_score_smem_bytes", [_I, _I, _I])(ns, k_cells, q)


@functools.lru_cache(maxsize=256)
def _plan(index: int, ns: int, m: int, k_cells: int, bc: int) -> tuple[int, int, int]:
    """``(Q, tile, bitmap words)`` of a launch on card ``index``."""
    props = torch.cuda.get_device_properties(index)
    q, tile = tiling(smem_bytes(ns, k_cells, 1), props.shared_memory_per_block_optin,
                     props.multi_processor_count, m, bc)
    return q, tile, -(-m // q) * q * ns * -(-k_cells // 32)


def _on(dev: torch.device):
    """The card ``dev`` as the current device: no context to enter when it
    already is."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def sc_score_cells(ranks: torch.Tensor, cuts: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    global cells_launches
    ns, m, k_cells = ranks.shape
    bc = cells.shape[1]
    dev = ranks.device
    q, tile, words = _plan(dev.index, ns, m, k_cells, bc)
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    bitmap = torch.empty((words,), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_cells", _CELLS_ARGTYPES)
    with _on(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0),
            ns, m, k_cells, bc, q, tile, bitmap.data_ptr(), scores.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index),
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
    q, tile, words = _plan(dev.index, ns, m, k_cells, bc)
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    keep = torch.empty((m, bc), dtype=torch.bool, device=dev)  # one byte, written 0 / 1
    bitmap = torch.empty((words,), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_cells_prefilter", _PREFILTER_ARGTYPES)
    with _on(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0), thr.data_ptr(),
            ns, m, k_cells, bc, q, tile, bitmap.data_ptr(), scores.data_ptr(), keep.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index),
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
