"""Launches of the SC-score CUDA kernels.

``csrc/sc_score.cu`` replaces the TPU kernels ``sc_score_cells_kernel``,
``sc_score_cells_prefilter_kernel`` and
``sc_score_cells_prefilter_compact_kernel``.  Each is launched from one C
entry point: a bitmap pass that reads the ranks once into device memory
(the activated sets, Q queries' bits side by side), then a sweep in which a
block serves Q queries and a tile of columns from that bitmap, copied into
shared memory or, where one query's bitmap does not fit there, read from
L2; the compaction adds each tile's survivor counts to the sweep and a
third pass, a warp per (query, tile), that places each tile's survivors
after the earlier tiles' by ballots.  :func:`tiling` picks the
route, Q and the tile from one query's bitmap bytes (the source's
``sc_score_smem_bytes``), the card's shared memory and its SM count.
Bytes bound them on an H100.  ``sc_score_fused`` of
``csrc/sc_score_fused.cu`` replaces ``sc_score_kernel``: a block of 64
queries and 128 points walks the subspaces, the cross terms on the tensor
cores in 3xTF32, and every pair whose screen distance lies within the
margin :func:`fused_screen_margin` (plus the floor
:func:`fused_screen_floor`) of its threshold is re-checked in the plain
arithmetic, so its counts are the plain version's bit for bit; bytes bound
it.  (See the sources' headers.)

The op wrappers (:mod:`.ops`) have checked every argument; this module
allocates the outputs and scratch, launches on the current stream and
raises on any CUDA error.  ``launches`` (the compact kernel),
``cells_launches``, ``prefilter_launches`` and ``fused_launches`` count the
launches (one for the passes of one C entry point).
:func:`sc_score_fused_probe` is the SC-score kernel with its instruments on
(re-checks per block, every screen distance), for the checks only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0
cells_launches = 0
prefilter_launches = 0
fused_launches = 0

QUERY_TILES = (16, 8, 4, 2, 1)  # queries a sweep block may serve (Q), widest first
MAX_TILE = 2048  # columns of a sweep block at most: 256 threads x 8
SHARED, L2 = "shared", "l2"  # where a sweep block reads its bitmap from
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _P]
_CELLS_ARGTYPES = [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
_PREFILTER_ARGTYPES = [_P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
_FUSED_ARGTYPES = [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _I, _F, _F, _I,
                   _P, _P, _P, _P]
_U = 2.0**-24  # unit roundoff of fp32
FUSED_QUERIES, FUSED_POINTS = 64, 128  # a block's query group and point tile (kBM, kBN)
FUSED_NORM_LIMIT = 2.0**125  # a norm above it enters the screen as NaN (kNormLimit)


def fused_screen_margin(s: int) -> float:
    """``mu_s``: the SC-score kernel re-checks a (pair, subspace) unless its
    screen distance ``d~`` lies more than ``delta = mu_s * (|q|^2 + |x|^2) +
    fused_screen_floor(s)`` from the threshold.  ``E_s = (5 s + 60) u``
    bounds ``|d~ - d_plain| / (|q|^2 + |x|^2)`` for fp32 arithmetic with
    round-to-nearest and the kernel's truncating TF32 split (the derivation
    is in the header of ``csrc/sc_score_fused.cu``: 4 s + 52 at first
    order); exactness needs the error within ``delta / 2``, and a safety
    factor of 4 covers the tensor cores' accumulation: ``mu_s = 8 E_s``."""
    return 8.0 * (5 * s + 60) * _U


def fused_screen_floor(s: int) -> float:
    """``eta_s``, the margin's absolute part: ``s * 2^-119``, 8 times the
    error of the products and partial sums the tensor cores may flush below
    2^-126 (the header's derivation)."""
    return s * 2.0**-119


def fused_vec(qs: torch.Tensor, xs: torch.Tensor) -> int:
    """The SC-score kernel's copy width, in floats: 4 (16-byte copies) where
    both views start on a 16-byte boundary and their subspace and row strides
    are multiples of 4 floats, else 1."""
    ok = all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
             for t in (qs, xs))
    return 4 if ok else 1


def fused_blocks(m: int, n: int) -> int:
    """The SC-score kernel's grid: one block a work item, a group of
    :data:`FUSED_QUERIES` queries and a tile of :data:`FUSED_POINTS`
    points."""
    return -(-m // FUSED_QUERIES) * -(-n // FUSED_POINTS)


def tiling(bitmap_bytes: int, smem_limit: int, n_sm: int, m: int, bc: int
           ) -> tuple[int, int, str]:
    """``(Q, tile, route)`` of the chunk-score sweep: a block serves ``Q``
    queries and ``tile`` columns.  On the :data:`SHARED` route the block
    copies its queries' bitmaps (``Q * bitmap_bytes``, one query's being
    ``bitmap_bytes``) into shared memory, and ``Q`` is the widest of
    :data:`QUERY_TILES` that fits in ``smem_limit``; where one query's
    bitmap does not fit, the route is :data:`L2` (the sweep reads the
    bitmap from device memory) and shared memory does not limit ``Q``.
    Either way ``Q`` is no wider than ``m`` rounded up to a power of two.
    ``tile`` (at most :data:`MAX_TILE`) gives the launch at least two blocks
    on each of ``n_sm`` SMs wherever ``bc`` has that many columns for each
    group of ``Q`` queries."""
    route = SHARED if bitmap_bytes <= smem_limit else L2
    q = next(q for q in QUERY_TILES
             if (route == L2 or q * bitmap_bytes <= smem_limit) and (q < 2 * m or q == 1))
    tiles = -(-2 * n_sm // -(-m // q))  # column tiles for two blocks an SM
    return q, min(MAX_TILE, max(1, bc // tiles)), route


def smem_bytes(ns: int, k_cells: int, q: int) -> int:
    """Shared memory of a sweep block serving ``q`` queries, in bytes, as the
    source lays it out (at most 2^31 - 1); builds the library if needed."""
    return _build.entry("sc_score", "sc_score_smem_bytes", [_I, _I, _I])(ns, k_cells, q)


class Plan(NamedTuple):
    """A launch's sweep: ``q`` queries and ``tile`` columns a block, its
    bitmap route (``l2`` true for :data:`L2`), the bitmap's words and the
    column tiles."""
    q: int
    tile: int
    l2: bool
    words: int
    tiles: int


def plan(bitmap_bytes: int, m: int, bc: int, smem_limit: int, n_sm: int) -> Plan:
    """The sweep of a launch over ``bc`` columns for ``m`` queries, one
    query's bitmap taking ``bitmap_bytes``, on a card with ``n_sm`` SMs and
    ``smem_limit`` bytes of shared memory a block: :func:`tiling`'s choice,
    the bitmap pass's words (``ceil(m/Q)`` groups of ``Q`` queries'
    bitmaps) and the ``ceil(bc / tile)`` column tiles whose survivors the
    compaction counts."""
    q, tile, route = tiling(bitmap_bytes, smem_limit, n_sm, m, bc)
    return Plan(q, tile, route == L2, -(-m // q) * q * bitmap_bytes // 4, -(-bc // tile))


@functools.lru_cache(maxsize=256)
def _plan(index: int, ns: int, m: int, k_cells: int, bc: int) -> Plan:
    """The sweep of a launch on card ``index``."""
    props = torch.cuda.get_device_properties(index)
    return plan(smem_bytes(ns, k_cells, 1), m, bc, props.shared_memory_per_block_optin,
                props.multi_processor_count)


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
    plan = _plan(dev.index, ns, m, k_cells, bc)
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    bitmap = torch.empty((plan.words,), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_cells", _CELLS_ARGTYPES)
    with _on(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0),
            ns, m, k_cells, bc, plan.q, plan.tile, plan.l2, bitmap.data_ptr(), scores.data_ptr(),
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
    plan = _plan(dev.index, ns, m, k_cells, bc)
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    keep = torch.empty((m, bc), dtype=torch.bool, device=dev)  # one byte, written 0 / 1
    bitmap = torch.empty((plan.words,), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_cells_prefilter", _PREFILTER_ARGTYPES)
    with _on(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0), thr.data_ptr(),
            ns, m, k_cells, bc, plan.q, plan.tile, plan.l2, bitmap.data_ptr(), scores.data_ptr(),
            keep.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    _build.check("sc_score", rc, "sc_score_cells_prefilter")
    prefilter_launches += 1
    return scores, keep


def _fused(qs, xs, tau, rechecks=None, screen=None) -> torch.Tensor:
    ns, m, s = qs.shape
    n = xs.shape[1]
    dev = qs.device
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score_fused", "sc_score_fused", _FUSED_ARGTYPES)
    with _on(dev):
        rc = fn(
            qs.data_ptr(), qs.stride(0), qs.stride(1), xs.data_ptr(), xs.stride(0), xs.stride(1),
            tau.data_ptr(), ns, m, n, s, fused_screen_margin(s), fused_screen_floor(s),
            fused_vec(qs, xs), out.data_ptr(),
            None if rechecks is None else rechecks.data_ptr(),
            None if screen is None else screen.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    _build.check("sc_score_fused", rc, "sc_score_fused")
    return out


def sc_score_fused(qs: torch.Tensor, xs: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    global fused_launches
    out = _fused(qs, xs, tau)
    fused_launches += 1
    return out


class FusedProbe(NamedTuple):
    scores: torch.Tensor  # (m, n) int32
    rechecks: torch.Tensor  # (fused_blocks(m, n),) int32: the pairs each block re-checked
    screen: torch.Tensor  # (Ns, m, n) f32: every screen distance d~


def sc_score_fused_probe(qs: torch.Tensor, xs: torch.Tensor, tau: torch.Tensor) -> FusedProbe:
    """The SC-score kernel on the op's checked arguments with its instruments
    on (:class:`FusedProbe`).  For the checks: the path never asks for them,
    and this launch is not counted."""
    ns, m, _ = qs.shape
    n = xs.shape[1]
    rechecks = torch.zeros((fused_blocks(m, n),), dtype=torch.int32, device=qs.device)
    screen = torch.empty((ns, m, n), dtype=torch.float32, device=qs.device)
    return FusedProbe(_fused(qs, xs, tau, rechecks, screen), rechecks, screen)


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
    plan = _plan(dev.index, ns, m, k_cells, bc)
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    surv_cols = torch.empty((m, cap), dtype=torch.int32, device=dev)
    surv_scores = torch.empty((m, cap), dtype=torch.int32, device=dev)
    count = torch.empty((m,), dtype=torch.int32, device=dev)
    scratch = torch.empty((plan.words + m * plan.tiles,), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_compact", _ARGTYPES)
    with _on(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0),
            thr.data_ptr(), None if keep_cols is None else keep_cols.data_ptr(),
            ns, m, k_cells, bc, max(0, min(limit, bc)), cap, plan.q, plan.tile, plan.l2,
            scratch.data_ptr(), scratch[plan.words:].data_ptr(),  # the bitmap, the tile counts
            scores.data_ptr(), surv_cols.data_ptr(), surv_scores.data_ptr(),
            count.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index),
        )
    _build.check("sc_score", rc, "sc_score_compact")
    launches += 1
    return scores, surv_cols, surv_scores, count
