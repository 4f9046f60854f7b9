"""The launches each kernel operator makes, computed without the card.

For each operator of :mod:`repro_torch.kernels._library`, :func:`launches`
returns the CUDA launches its ``CUDA`` implementation makes at given
argument shapes on a card of given limits: the kernel, its grid, its
threads a block and its dynamic shared memory.  The route choices are the
implementations' own functions (``sc_score/kernel.py::plan``,
``kmeans_assign/ops.py::_stats_wide`` / ``_pair_wide`` /
``_batched_wide``), asked with the same shapes.  The shared-memory sizes,
the threads and the grids are Python copies of the sources' launchers:
``chip_smoke.py``'s ``static_gate`` phase holds the sizes against the
built libraries' own functions, and these plans against the kernels a
profiled run on the card launches (names, grids, threads and dynamic
shared memory).  The ``tile-shape`` rule of the static gate reads these
plans.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

__all__ = [
    "Launch", "launches", "blocks_per_sm", "RESERVED_SMEM_BYTES", "sweep_smem_bytes",
    "stats_smem_bytes", "pair_smem_bytes",
    "narrow_smem_bytes", "SCREEN_SMEM_BYTES", "FUSED_SMEM_BYTES", "THREADS",
]

_F, _I, _U64 = 4, 4, 8  # sizeof(float), sizeof(int), sizeof(unsigned long long)

#: Threads a block of each kernel function (the sources' ``__launch_bounds__``):
#: every plan's launches take theirs from here.
THREADS = {
    "gather_rerank_l2_kernel": 256,
    "pairwise_sqdist_kernel": 128,
    "sc_bitmap_kernel": 128,
    "sc_sweep_kernel": 256,
    "sc_compact_kernel": 256,
    "sc_score_fused_kernel": 256,
    "kmeans_stats_partial_kernel": 256,
    "kmeans_stats_reduce_kernel": 256,
    "kmeans_stats_wide_accumulate_kernel": 256,
    "centroid_norms_kernel": 256,
    "kmeans_assign_streamed_kernel": 256,
    "kmeans_assign_narrow_kernel": 256,
    "kmeans_pair_assign_hist_kernel": 256,
    "kmeans_pair_hist_kernel": 256,
    "linear_attn_kernel": 256,
    "scattered_read_probe_kernel": 256,
}


#: Shared memory the card sets aside for each resident block (sm_90): it
#: counts against an SM's shared memory; ``cuobjdump -res-usage``'s
#: ``SHARED`` includes it for a kernel that uses it (all here but
#: ``gather_rerank_l2_kernel``), the profiler's shared memory never does.
RESERVED_SMEM_BYTES = 1_024
_MAX_BLOCKS_PER_SM = 32
#: the paired assignment's static shared memory (``cmax_bits[2]``, ``qn[2]``)
_PAIR_STATIC_SMEM = 16
_REG_UNIT = 256  # registers are given to a warp in units of this many


def blocks_per_sm(threads: int, registers: int, smem_bytes: int, limits) -> int:
    """Blocks of ``threads`` threads using ``registers`` registers a thread
    and ``smem_bytes`` of shared memory (dynamic plus static) that fit one
    SM of a card of ``limits``: what ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    answers."""
    warps = _cdiv(threads, 32)
    per_warp = _cdiv(registers * 32, _REG_UNIT) * _REG_UNIT
    return max(0, min(_MAX_BLOCKS_PER_SM, limits.max_threads_per_sm // (warps * 32),
                      limits.regs_per_sm // (warps * per_warp),
                      limits.smem_per_sm_bytes // (smem_bytes + RESERVED_SMEM_BYTES)))


class Launch(NamedTuple):
    kernel: str
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int  # dynamic shared memory


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---- copies of the sources' shared-memory sizes ---------------------------


def sweep_smem_bytes(ns: int, k_cells: int, q: int) -> int:
    """``csrc/sc_score.cu::sweep_smem_bytes``: ``ns`` rows of ``q`` queries'
    bitmap words."""
    return q * ns * ((k_cells + 31) >> 5) * _I


def stats_smem_bytes(k: int, s: int) -> int:
    """``csrc/kmeans_assign.cu::stats_smem_bytes`` (8 warps of 32)."""
    pts = 2 if s <= 16 else 1
    return (_F * (k * s + k * (s + 1) + pts * 256 * s + pts * 8)
            + _I * (k + 1 + 8) + pts * 8 * k)


def _pair_maxs(s: int) -> int:
    return 4 if s <= 4 else 8 if s <= 8 else 16 if s <= 16 else 32 if s <= 32 else 64


def pair_smem_bytes(k: int, s: int) -> int:
    """``csrc/kmeans_assign.cu::pair_smem_bytes`` at ``pair_maxs(s)``."""
    maxs = _pair_maxs(s)
    tile = (8 if maxs <= 8 else 64 // maxs) * 256
    return _F * (2 * k * maxs + 2 * k) + _I * (k * k + 4 * tile)


def _narrow_ks(s: int) -> int:
    return 1 if s <= 8 else 2 if s <= 16 else 4 if s <= 32 else 8


def narrow_smem_bytes(k: int, s: int) -> int:
    """``csrc/kmeans_assign.cu::narrow_smem_bytes`` at ``narrow_ks(s)``."""
    return (k + 15) // 16 * 2 * (16 * 32 * _narrow_ks(s) + _F * 8)


#: ``kScreenSmem`` of the screened assignment (kBM 128, kBN 64, kLdS 48,
#: kWN 2, kL 8)
SCREEN_SMEM_BYTES = (_F * (2 * 128 * 48 + 2 * 64 * 48 + 2 * 128 + 3 * 128) + _U64 * 128
                     + _I * 128 + (_I + _F) * 128 * 8)
#: ``kSmem`` of the SC-score kernel (3 stages of (128 + 64) x 16 floats,
#: kBN 128, kBM 64, 8 warps)
FUSED_SMEM_BYTES = _F * (3 * (128 + 64) * 16 + 2 * 128 + 3 * 64) + _I * 8


# ---- the launches of each operator ----------------------------------------


def _launch(kernel: str, grid: tuple[int, int, int], smem_bytes: int) -> Launch:
    return Launch(kernel, grid, THREADS[kernel], smem_bytes)


def _screened(b: int, n: int, k: int) -> list[Launch]:
    return [_launch("centroid_norms_kernel", (_cdiv(b * k, 256), 1, 1), 0),
            _launch("kmeans_assign_streamed_kernel", (_cdiv(n, 128), b, 1),
                    SCREEN_SMEM_BYTES)]


def _sc_cells(ranks, cells, limits, compact: bool) -> list[Launch]:
    from repro_torch.kernels.sc_score import kernel

    ns, m, k_cells = ranks.shape
    bc = cells.shape[1]
    plan = kernel.plan(sweep_smem_bytes(ns, k_cells, 1), m, bc, limits.smem_optin_bytes,
                       limits.n_sm)
    groups = _cdiv(m, plan.q)
    out = [_launch("sc_bitmap_kernel", (_cdiv(plan.words, 128), 1, 1), 0),
           _launch("sc_sweep_kernel", (plan.tiles * groups, 1, 1),
                   0 if plan.l2 else sweep_smem_bytes(ns, k_cells, plan.q))]
    if compact:
        out.append(_launch("sc_compact_kernel", (_cdiv(plan.tiles * m, 8), 1, 1), 0))
    return out


def launches(op: str, args: Sequence, limits, registers: Mapping[str, int] | None = None
             ) -> list[Launch]:
    """The launches of operator ``op`` (its name without the namespace) on
    arguments ``args`` (anything with a ``shape`` for a tensor) on a card of
    ``limits`` (:func:`repro_torch.core.tuning.static_device_limits`).
    ``registers`` (a thread's, by kernel) sets the occupancy a launcher that
    sizes its grid to one wave reads; a kernel it does not name is taken at
    255, the most a thread may have: the fewest blocks an SM."""
    from repro_torch.kernels.gather_rerank import kernel as rerank
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.pairwise_l2 import kernel as pairwise
    from repro_torch.kernels.sc_score import kernel as score

    if op == "gather_rerank_block":  # rows taken as aligned: the widest load d allows
        (m, c), d = args[0].shape, args[1].shape[1]
        return [_launch("gather_rerank_l2_kernel", (rerank.blocks(m * c, d, rerank.vec(d)), 1, 1),
                        0)]
    if op == "pairwise_sqdist":
        m, n = args[0].shape[0], args[1].shape[0]
        return [_launch("pairwise_sqdist_kernel", (pairwise.items(m, n), 1, 1), 0)]
    if op == "sc_scores_fused":
        m, n = args[0].shape[1], args[1].shape[1]
        return [_launch("sc_score_fused_kernel", (score.fused_blocks(m, n), 1, 1),
                        FUSED_SMEM_BYTES)]
    if op in ("sc_scores_cells", "sc_scores_cells_prefilter"):
        return _sc_cells(args[0], args[2], limits, compact=False)
    if op == "sc_scores_cells_prefilter_compact":
        return _sc_cells(args[0], args[2], limits, compact=True)
    if op == "kmeans_stats":
        (b, n, s), k, block_n = args[0].shape, args[1].shape[1], args[2]
        nblk = _cdiv(n, block_n)
        reduce = _launch("kmeans_stats_reduce_kernel",
                        (min(_cdiv(k * s + k + 1, 256), 1024), b, 1), 0)
        smem = stats_smem_bytes(k, s)
        if not kmeans_ops._stats_wide(s, smem):
            return [_launch("kmeans_stats_partial_kernel", (nblk, b, 1), smem), reduce]
        groups = min(8, max(1, _cdiv(2 * limits.n_sm, nblk * b)))
        return [*_screened(b, n, k),
                _launch("kmeans_stats_wide_accumulate_kernel", (nblk * groups, b, 1), 0),
                reduce]
    if op == "kmeans_pair_assign_hist":
        (b, n, s), k = args[0].shape, args[1].shape[1]
        ns = b // 2
        smem = pair_smem_bytes(k, s)
        if not kmeans_ops._pair_wide(s, smem):
            # one wave: the card's resident blocks shared among the
            # subspaces, each block a run of whole tiles
            kern = "kmeans_pair_assign_hist_kernel"
            tile = (8 if _pair_maxs(s) <= 8 else 64 // _pair_maxs(s)) * 256
            tiles = _cdiv(n, tile)
            per_sm = blocks_per_sm(THREADS[kern], (registers or {}).get(kern, 255),
                                   smem + _PAIR_STATIC_SMEM, limits)
            per_sub = max(1, min(tiles, _cdiv(limits.n_sm * max(per_sm, 1), ns)))
            chunk = _cdiv(tiles, per_sub) * tile
            return [_launch(kern, (_cdiv(n, chunk), ns, 1), smem)]
        return [*_screened(b, n, k),
                _launch("kmeans_pair_hist_kernel",
                       (min(_cdiv(n, 256), max(1, 2 * limits.n_sm // ns)), ns, 1), 0)]
    if op == "kmeans_assign_batched":
        (b, n, s), k = args[0].shape, args[1].shape[1]
        smem = narrow_smem_bytes(k, s)
        if kmeans_ops._batched_wide(s, smem):
            return _screened(b, n, k)
        mt = 1 if _narrow_ks(s) == 8 else 2
        return [_launch("kmeans_assign_narrow_kernel", (_cdiv(n, 8 * 8 * mt * 16), b, 1),
                        smem)]
    if op == "kmeans_assign":
        return _screened(1, args[0].shape[0], args[1].shape[0])
    raise ValueError(f"no launch plan for operator {op!r}")
