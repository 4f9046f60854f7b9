"""Launches of the CUDA kernels ``csrc/kmeans_assign.cu`` (which replace the
TPU kernels ``kmeans_stats_kernel`` and ``kmeans_pair_assign_hist_kernel``):
grid (chunks of ``block_n`` points, codebooks), the codebook's centroids in
shared memory, one point per thread.  Operations bound them on an H100 (see
the source's header).

The op wrappers (:mod:`.ops`) have checked every argument; this module
allocates outputs and scratch, launches on the current stream and raises on
any CUDA error.  ``stats_launches`` and ``pair_hist_launches`` count the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

stats_launches = 0
pair_hist_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_STATS_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]
_PAIR_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P]


def kmeans_stats(
    x: torch.Tensor, centroids: torch.Tensor, block_n: int, with_assign: bool
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    global stats_launches
    b, n, s = x.shape
    k = centroids.shape[1]
    nblk = -(-n // block_n)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    # per-block partials, reduced over the blocks in block order
    part_sums = torch.empty((b, nblk, k, s), **f32)
    part_counts = torch.empty((b, nblk, k), **f32)
    part_inertia = torch.empty((b, nblk), **f32)
    sums = torch.empty((b, k, s), **f32)
    counts = torch.empty((b, k), **f32)
    inertia = torch.empty((b,), **f32)
    assign = torch.empty((b, n), dtype=torch.int32, device=dev) if with_assign else None
    fn = _build.entry("kmeans_assign", "kmeans_stats", _STATS_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), centroids.data_ptr(), b, n, k, s, block_n,
            part_sums.data_ptr(), part_counts.data_ptr(), part_inertia.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(),
            None if assign is None else assign.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("kmeans_assign", rc, "kmeans_stats")
    stats_launches += 1
    return assign, sums, counts, inertia


def kmeans_pair_assign_hist(
    x: torch.Tensor, centroids: torch.Tensor, block_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    global pair_hist_launches
    b, n, s = x.shape
    k = centroids.shape[1]
    ns = b // 2
    dev = x.device
    assign = torch.empty((b, n), dtype=torch.int32, device=dev)
    counts = torch.zeros((ns, k * k), dtype=torch.int32, device=dev)
    fn = _build.entry("kmeans_assign", "kmeans_pair_assign_hist", _PAIR_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), centroids.data_ptr(), ns, n, k, s, block_n,
            assign.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("kmeans_assign", rc, "kmeans_pair_assign_hist")
    pair_hist_launches += 1
    return assign, counts
