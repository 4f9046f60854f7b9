"""The K-means passes: Lloyd statistics, the paired final assignment with
the IMI histogram, and nearest-centroid assignment (batched, and a single
problem of any width).  Each checks its arguments, then dispatches on the
device of the tensors it was given.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel (:mod:`.kernel`), and a failed build or launch raises: each op
calls one operator ``torch.ops.repro_torch.<op>``, which dispatches by
device (:mod:`repro_torch.kernels._library`); the variant is chosen inside
the ``CUDA`` implementation, so nothing is built before a launch.
``block_n`` is the chunk of points: the plain version's memory bound, and
the points each block of the kernel takes.

Every op takes any width ``s`` and any ``k``, as the JAX package's do.  The
batched kernels come in two variants, chosen here by shape: the narrow one
holds a point in registers (``s <= MAX_DIM``) and the codebook (the pair
assignment: both codebooks and the ``k^2`` histogram) in shared memory
(:func:`_fits`, at the size the source states); the wide one streams the
centroids through shared memory for any other shape (the batched
assignment also past 32 dims where two narrow blocks do not fit an SM, as
it is faster there).  Both give the same results.  Every assignment
variant, and :func:`kmeans_assign`'s kernel (the wide one), screens the
centroids -- on the tensor cores, or with fused multiply-adds for the
narrow pair assignment -- and re-checks in the plain arithmetic every one
its margin does not rule out, so they give the plain version's argmins bit
for bit; their blocks take chunks of their own size whatever ``block_n``.
The wide statistics take their argmins from the wide assignment and add
each chunk's points in the narrow kernel's order: the same bits as the
narrow statistics.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _library
from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.kmeans_assign import kernel
from repro_torch.kernels.kmeans_assign.ref import (
    kmeans_assign_batched_ref,
    kmeans_assign_ref,
    kmeans_pair_assign_hist_ref,
    kmeans_stats_ref,
)

__all__ = [
    "kmeans_stats", "kmeans_pair_assign_hist", "kmeans_assign_batched", "kmeans_assign",
    "MAX_DIM",
]

#: Widest (half-)subspace a thread of the narrow batched kernels holds in
#: registers; wider ones take the wide variants.
MAX_DIM = 64
_SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
#: Past this width the screened assignment pads no dims (its slices are 32
#: wide), and the narrow one is faster only where two of its blocks fit an SM
#: (its launch bounds): at s = 64, k = 50 / 128 the narrow kernel takes
#: 0.070 / 0.148 ms against the screen's 0.117 / 0.181, at k = 256 (one
#: block an SM) 0.543 against 0.314 (H100 80GB HBM3, tools/time_assign.py).
_SCREEN_SLICE = 32


def _check(x, centroids, block_n) -> tuple[int, int, int, int]:
    b, n, s = check_tensor("x", x, torch.float32, 3)
    k = check_tensor("centroids", centroids, torch.float32, 3)[1]
    if centroids.shape[0] != b or centroids.shape[2] != s:
        raise ValueError(
            f"centroids must be ({b}, k, {s}), got {tuple(centroids.shape)}"
        )
    if min(b, n, s, k) < 1 or block_n < 1:
        raise ValueError(f"need B, n, s, k and block_n >= 1, got {b}/{n}/{s}/{k}/{block_n}")
    return b, n, s, k


def _fits(s: int, smem: int) -> bool:
    """Whether the narrow variant takes a shape: a point of ``s`` dims in
    registers and ``smem`` bytes of shared memory."""
    return s <= MAX_DIM and smem <= _SMEM_LIMIT


# The route of each batched op at width ``s``, given the narrow block's
# shared memory as the source lays it out: the CUDA implementations below
# and the static gate's launch plans (``kernels/_plans.py``) both ask these.


def _stats_wide(s: int, smem: int) -> bool:
    """Whether the Lloyd statistics take the wide route (``smem``: the
    narrow block's codebook and partial sums)."""
    return not _fits(s, smem)


def _pair_wide(s: int, smem: int) -> bool:
    """Whether the paired assignment takes the wide route (``smem``: both
    codebooks and the ``k*k`` histogram)."""
    return not _fits(s, smem)


def _batched_wide(s: int, smem: int) -> bool:
    """Whether the batched assignment takes the screened route (``smem``:
    the split codebook and its norms)."""
    return not _fits(s, smem) or (s > _SCREEN_SLICE and smem > _SMEM_LIMIT // 2)


def _i32(like: torch.Tensor, shape) -> torch.Tensor:
    return like.new_empty(shape, dtype=torch.int32)


def _stats_cpu(x, centroids, block_n, with_assign):
    a, sums, counts, inertia = kmeans_stats_ref(x, centroids, block_n=block_n)
    return (a if with_assign else _i32(x, (0,))), sums, counts, inertia


def _stats_cuda(x, centroids, block_n, with_assign):
    b, n, s = x.shape
    k = centroids.shape[1]
    wide = _stats_wide(s, kernel.stats_smem_bytes(k, s))
    a, sums, counts, inertia = kernel.kmeans_stats(x, centroids, block_n, with_assign, wide)
    return (a if with_assign else _i32(x, (0,))), sums, counts, inertia


def _stats_meta(x, centroids, block_n, with_assign):
    b, n, s = x.shape
    k = centroids.shape[1]
    return (_i32(x, (b, n) if with_assign else (0,)), x.new_empty((b, k, s)),
            x.new_empty((b, k)), x.new_empty((b,)))


def _pair_cpu(x, centroids, block_n):
    return kmeans_pair_assign_hist_ref(x, centroids, block_n=block_n)


def _pair_cuda(x, centroids, block_n):
    s, k = x.shape[2], centroids.shape[1]
    wide = _pair_wide(s, kernel.pair_smem_bytes(k, s))
    return kernel.kmeans_pair_assign_hist(x, centroids, wide)


def _pair_meta(x, centroids, block_n):
    b, n, _ = x.shape
    k = centroids.shape[1]
    return _i32(x, (b, n)), _i32(x, (b // 2, k * k))


def _batched_cpu(x, centroids, block_n):
    return kmeans_assign_batched_ref(x, centroids, block_n=block_n)


def _batched_cuda(x, centroids, block_n):
    s, k = x.shape[2], centroids.shape[1]
    wide = _batched_wide(s, kernel.narrow_smem_bytes(k, s))
    return kernel.kmeans_assign_batched(x, centroids, wide)


def _batched_meta(x, centroids, block_n):
    return _i32(x, x.shape[:2])


def _assign_cpu(x, centroids):
    return kmeans_assign_ref(x, centroids)


def _assign_cuda(x, centroids):
    return kernel.kmeans_assign(x, centroids)


def _assign_meta(x, centroids):
    return _i32(x, x.shape[:1])


_STATS = _library.define(
    "kmeans_stats(Tensor x, Tensor centroids, int block_n, bool with_assign)"
    " -> (Tensor, Tensor, Tensor, Tensor)",
    cpu=_stats_cpu, cuda=_stats_cuda, meta=_stats_meta,
)
_PAIR = _library.define(
    "kmeans_pair_assign_hist(Tensor x, Tensor centroids, int block_n) -> (Tensor, Tensor)",
    cpu=_pair_cpu, cuda=_pair_cuda, meta=_pair_meta,
)
_BATCHED = _library.define(
    "kmeans_assign_batched(Tensor x, Tensor centroids, int block_n) -> Tensor",
    cpu=_batched_cpu, cuda=_batched_cuda, meta=_batched_meta,
)
_ASSIGN = _library.define(
    "kmeans_assign(Tensor x, Tensor centroids) -> Tensor",
    cpu=_assign_cpu, cuda=_assign_cuda, meta=_assign_meta,
)


def kmeans_stats(
    x: torch.Tensor,
    centroids: torch.Tensor,
    *,
    block_n: int,
    with_assign: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd statistics pass over ``B`` codebooks: ``x: (B, n, s)``,
    ``centroids: (B, k, s)`` -> ``(assign (B, n) int32 | None, sums
    (B, k, s) f32, counts (B, k) f32, inertia (B,) f32)``; ``assign`` only
    ``with_assign``."""
    _check(x, centroids, block_n)
    _library.route(same_device(x, centroids), "kmeans_stats")
    a, sums, counts, inertia = _STATS(x, centroids, block_n, with_assign)
    return (a if with_assign else None), sums, counts, inertia


def kmeans_pair_assign_hist(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Final assignment + IMI occupancy: ``x: (2Ns, n, s)``, ``centroids:
    (2Ns, k, s)`` -> ``(assign (2Ns, n) int32, cell_counts (Ns, k*k) int32)``;
    the caller forms ``cell_ids = a1 * k + a2``."""
    b, n, s, k = _check(x, centroids, block_n)
    if b % 2:
        raise ValueError(f"paired layout needs an even batch, got B={b}")
    _library.route(same_device(x, centroids), "kmeans_pair_assign_hist")
    return _PAIR(x, centroids, block_n)


def kmeans_assign_batched(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> torch.Tensor:
    """Nearest centroid per codebook: ``x: (B, n, s)``, ``centroids:
    (B, k, s)`` -> ``(B, n)`` int32, lowest index on ties."""
    _check(x, centroids, block_n)
    _library.route(same_device(x, centroids), "kmeans_assign_batched")
    return _BATCHED(x, centroids, block_n)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of one problem at any width and any ``k``: ``x:
    (n, s)``, ``centroids: (k, s)`` -> ``(n,)`` int32, lowest index on
    ties."""
    n, s = check_tensor("x", x, torch.float32, 2)
    k = check_tensor("centroids", centroids, torch.float32, 2)[0]
    if centroids.shape[1] != s:
        raise ValueError(f"centroids must be (k, {s}), got {tuple(centroids.shape)}")
    if min(n, s, k) < 1:
        raise ValueError(f"need n, s and k >= 1, got {n}/{s}/{k}")
    _library.route(same_device(x, centroids), "kmeans_assign")
    return _ASSIGN(x, centroids)


# --------------------------------------------------------------------------
# Static-gate registry hook (see repro_torch.analysis)
# --------------------------------------------------------------------------


def lint_entries():
    from repro_torch.analysis.registry import TileEntry, TraceEntry
    from repro_torch.analysis.trace_rules import trace

    b, n, s, k, bn = 8, 2_048, 128, 32, 1_024

    def inputs():
        g = torch.Generator().manual_seed(0)
        return torch.randn((b, n, s), generator=g), torch.randn((b, k, s), generator=g)

    return [
        TileEntry(name="kernels.kmeans_assign.batched", contract={},
                  make=lambda: trace(kmeans_assign_batched, *inputs(), block_n=bn),
                  note="batched nearest centroid (the screened kernel past 64 dims)"),
        TileEntry(name="kernels.kmeans_assign.stats", contract={},
                  make=lambda: trace(kmeans_stats, *inputs(), block_n=bn, with_assign=True),
                  note="Lloyd statistics: argmins, sums, counts, inertia"),
        TileEntry(name="kernels.kmeans_assign.pair_hist", contract={},
                  make=lambda: trace(kmeans_pair_assign_hist, *inputs(), block_n=bn),
                  note="paired final assignment and the IMI histogram"),
        TraceEntry(
            name="kernels.kmeans_assign.oracle",
            make=lambda: trace(kmeans_stats_ref, *inputs(), block_n=bn),
            rules=("bounded-intermediate", "pinned-accumulator"),
            budget_bytes=4 * 2 * b * n * max(k, s),
            note="the plain version of the Lloyd statistics (the CPU path)",
        ),
    ]
