"""Launches of the CUDA kernels ``csrc/kmeans_assign.cu``, which replace the
four TPU kernels of ``repro/kernels/kmeans_assign/kernel.py``:
``kmeans_stats_kernel`` (grid: chunks of ``block_n`` points x codebooks;
narrow: the codebook's centroids in shared memory, one or two points per
thread in registers; ``wide``: see below), ``kmeans_pair_assign_hist_kernel``,
``kmeans_assign_batched_kernel`` and ``kmeans_assign_kernel`` (one problem
of any width and any ``k``).  The fourth, the wide batched assignment and
the wide pair assignment are one CUDA kernel,
``kmeans_assign_streamed_kernel``, at one codebook, at ``B`` and at ``2Ns``:
a 3xTF32 tensor-core screen whose candidates within the margin
:func:`screen_margin` are re-checked in the plain arithmetic, so its argmins
are the plain version's bit for bit (see the source's header); the wide
pair assignment then adds its cells with ``kmeans_pair_hist_kernel``.  The
narrow batched assignment (``s <= 64``, the split codebook in shared memory)
is ``kmeans_assign_narrow_kernel``: a 3xTF32 screen too, with the codebook
resident and the points' fragments in registers, its margin
:func:`narrow_margin`.  The narrow pair assignment (``s <= 64``, both
codebooks and the ``k^2`` histogram in shared memory) is
``kmeans_pair_assign_hist_kernel``: an FFMA screen, points in registers,
whose points with a runner-up within :func:`narrow_margin` are re-checked
in the plain arithmetic.  The narrow and wide assignment kernels' blocks
take their own chunks of points, whatever ``block_n``.  The wide statistics
take their argmins, and each point's exact best distance, from the
streamed kernel, then add each point once in (centroid, index) order, as
the narrow statistics kernel does: both give the same bits.

The op wrappers (:mod:`.ops`) have checked every argument; this module
allocates outputs and scratch, launches on the current stream and raises on
any CUDA error.  ``stats_launches``, ``pair_hist_launches``,
``assign_batched_launches`` and ``assign_launches`` count the launches.
:func:`kmeans_assign_probe` is the screened kernel with its instruments on
(re-checks per block, the screen's distances, each point's best distance),
for the checks only; :func:`kmeans_assign_narrow_probe` is the narrow
kernel's and :func:`kmeans_pair_assign_hist_probe` the narrow pair kernel's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

stats_launches = 0
pair_hist_launches = 0
assign_batched_launches = 0
assign_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
_STATS_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P]
_PAIR_ARGTYPES = [_P, _P, _I, _I, _I, _I, _P, _P, _I, _F, _P, _P, _P, _P]
_ASSIGN_BATCHED_ARGTYPES = [_P, _P, _I, _I, _I, _I, _P, _I, _F, _P, _P, _P, _P, _P]
_ASSIGN_ARGTYPES = [_P, _P, _I, _I, _I, _F, _P, _P, _P]
_U = 2.0**-24  # unit roundoff of fp32
SCREEN_BLOCK_POINTS = 128  # points per block of the screened kernel (kBM in the source)


def screen_margin(s: int) -> float:
    """``mu_s``: the screened assignment re-checks centroid ``j`` of point
    ``p`` when its screen distance lies within ``delta_p = mu_s * (|x_p|^2 +
    max_j |c_j|^2)`` of the running screen minimum.  ``E_s = (7 s + 20) u``
    bounds ``|screen - d_plain| / (|x_p|^2 + max_j |c_j|^2)`` for fp32
    arithmetic with round-to-nearest (the derivation is in the header of
    ``csrc/kmeans_assign.cu``: 6.003 s + 19.04 at first order); exactness
    needs the error within ``delta_p / 2``, and a safety factor of 4 covers
    the tensor cores' accumulation: ``mu_s = 8 E_s``."""
    return 8.0 * (7 * s + 20) * _U


def narrow_margin(s: int) -> float:
    """``mu_s`` of the narrow assignment kernel: centroid ``j`` of point ``p``
    is a candidate when its screen value ``t_j = x.c_j - |c_j|^2 / 2`` lies
    within ``delta_p / 2`` of the point's largest, ``delta_p = mu_s (|x_p|^2
    + max_j |c_j|^2)``, i.e. its screen distance ``|x_p|^2 - 2 t_j`` within
    ``delta_p`` of the smallest.  ``E_s = (10 s + 20) u`` bounds ``|(|x_p|^2
    - 2 t_j) - d_plain| / (|x_p|^2 + max_j |c_j|^2)``: the accumulator starts
    at ``-|c_j|^2 / 2``, so ``3 s + 1`` terms of absolute sum up to ``N_p``
    are added (9.006 s + 16 at first order; the header of
    ``csrc/kmeans_assign.cu`` derives it).  ``mu_s = 8 E_s``, as in
    :func:`screen_margin`.  The narrow pair kernel's FFMA screen (``t_j`` a
    chain of ``s`` fused multiply-adds from ``-|c_j|^2 / 2``) takes the same
    margin: its error is 5 s + 4 at first order (derived in the same
    header), half of ``E_s``."""
    return 8.0 * (10 * s + 20) * _U


def narrow_smem_bytes(k: int, s: int) -> int:
    """Shared memory of a narrow assignment block at ``(k, s <= 64)``, in
    bytes, as the source lays it out (the split codebook and the centroids'
    norms; at most 2^31 - 1); builds the library if needed."""
    return _build.entry("kmeans_assign", "kmeans_assign_narrow_smem_bytes", [_I, _I])(k, s)


def pair_smem_bytes(k: int, s: int) -> int:
    """Shared memory of a narrow pair block at ``(k, s <= 64)``, in bytes, as
    the source lays it out (both codebooks, their norms, the ``k^2``
    histogram and a tile's bookkeeping; at most 2^31 - 1); builds the library
    if needed."""
    return _build.entry("kmeans_assign", "kmeans_pair_smem_bytes", [_I, _I])(k, s)


def stats_smem_bytes(k: int, s: int) -> int:
    """Shared memory of a narrow statistics block at ``(k, s)``, in bytes, as
    the source lays it out (at most 2^31 - 1); builds the library if needed."""
    return _build.entry("kmeans_assign", "kmeans_stats_smem_bytes", [_I, _I])(k, s)


def kmeans_stats(
    x: torch.Tensor, centroids: torch.Tensor, block_n: int, with_assign: bool, wide: bool
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
    # the wide variant's argmins and best distances come from the screened
    # kernel (norms: its scratch), so it always writes the assignments
    assign = (torch.empty((b, n), dtype=torch.int32, device=dev)
              if with_assign or wide else None)
    norms = torch.empty((b * k + b,), **f32) if wide else None
    best = torch.empty((b, n), **f32) if wide else None
    fn = _build.entry("kmeans_assign", "kmeans_stats", _STATS_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), centroids.data_ptr(), b, n, k, s, block_n,
            part_sums.data_ptr(), part_counts.data_ptr(), part_inertia.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(),
            None if assign is None else assign.data_ptr(), int(wide),
            screen_margin(s) if wide else 0.0,
            None if norms is None else norms.data_ptr(),
            None if best is None else best.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("kmeans_assign", rc, "kmeans_stats")
    stats_launches += 1
    return (assign if with_assign else None), sums, counts, inertia


def _pair(x, centroids, wide, rechecks=None, screen=None) -> tuple[torch.Tensor, torch.Tensor]:
    global pair_hist_launches
    b, n, s = x.shape
    k = centroids.shape[1]
    ns = b // 2
    dev = x.device
    assign = torch.empty((b, n), dtype=torch.int32, device=dev)
    counts = torch.zeros((ns, k * k), dtype=torch.int32, device=dev)
    # the wide route's scratch: every |c|^2, then each codebook's largest
    norms = torch.empty((b * k + b,), dtype=torch.float32, device=dev) if wide else None
    fn = _build.entry("kmeans_assign", "kmeans_pair_assign_hist", _PAIR_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), centroids.data_ptr(), ns, n, k, s, assign.data_ptr(),
            counts.data_ptr(), int(wide), screen_margin(s) if wide else narrow_margin(s),
            None if norms is None else norms.data_ptr(),
            None if rechecks is None else rechecks.data_ptr(),
            None if screen is None else screen.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("kmeans_assign", rc, "kmeans_pair_assign_hist")
    pair_hist_launches += 1
    return assign, counts


def kmeans_pair_assign_hist(
    x: torch.Tensor, centroids: torch.Tensor, wide: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    return _pair(x, centroids, wide)


class PairProbe(NamedTuple):
    assign: torch.Tensor  # (2Ns, n) int32
    counts: torch.Tensor  # (Ns, k*k) int32
    rechecks: torch.Tensor  # (Ns * blocks,) int32: re-checked (point, half)s per block
    screen: torch.Tensor | None  # (2Ns, n, k) f32: every t, if asked


def kmeans_pair_assign_hist_probe(
    x: torch.Tensor, centroids: torch.Tensor, *, screen: bool = False
) -> PairProbe:
    """The narrow pair kernel (``s <= 64``, its block within shared memory)
    on ``x: (2Ns, n, s)``, ``centroids: (2Ns, k, s)`` with its instruments
    on: each block's re-checked (point, half)s (a point the screen does not
    settle is scanned over every centroid), and with ``screen`` every screen
    value ``t_j = x.c_j - |c_j|^2 / 2`` (the screen distance is ``|x|^2 -
    2 t_j``).  For the checks only."""
    b, n, _ = x.shape
    k = centroids.shape[1]
    dev = x.device
    # the blocks take whole tiles of at least 256 points: room for every block
    rechecks = torch.zeros((b // 2 * -(-n // 256),), dtype=torch.int32, device=dev)
    out = torch.empty((b, n, k), dtype=torch.float32, device=dev) if screen else None
    assign, counts = _pair(x, centroids, False, rechecks, out)
    return PairProbe(assign, counts, rechecks, out)


def _batched(x, centroids, wide, rechecks=None, screen=None, best=None) -> torch.Tensor:
    global assign_batched_launches
    b, n, s = x.shape
    k = centroids.shape[1]
    dev = x.device
    assign = torch.empty((b, n), dtype=torch.int32, device=dev)
    # the wide kernel's scratch: every |c|^2, then each codebook's largest
    norms = torch.empty((b * k + b,), dtype=torch.float32, device=dev) if wide else None
    fn = _build.entry("kmeans_assign", "kmeans_assign_batched", _ASSIGN_BATCHED_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), centroids.data_ptr(), b, n, k, s, assign.data_ptr(),
            int(wide), screen_margin(s) if wide else narrow_margin(s),
            None if norms is None else norms.data_ptr(),
            None if rechecks is None else rechecks.data_ptr(),
            None if screen is None else screen.data_ptr(),
            None if best is None else best.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("kmeans_assign", rc, "kmeans_assign_batched")
    assign_batched_launches += 1
    return assign


def kmeans_assign_batched(x: torch.Tensor, centroids: torch.Tensor, wide: bool) -> torch.Tensor:
    return _batched(x, centroids, wide)


class Probe(NamedTuple):
    assign: torch.Tensor  # (B, n) int32
    rechecks: torch.Tensor  # (B, blocks) int32: re-checked pairs per block
    screen: torch.Tensor | None  # (B, n, k) f32: the screen's distances, if asked
    best: torch.Tensor  # (B, n) f32: each point's exact best distance d*


def kmeans_assign_probe(
    x: torch.Tensor, centroids: torch.Tensor, *, screen: bool = False
) -> Probe:
    """The screened kernel on ``x: (B, n, s)``, ``centroids: (B, k, s)`` with
    its instruments on (:class:`Probe`).  For the checks: the path never asks
    for them (row 3's wide variant asks for ``best`` alone)."""
    b, n, _ = x.shape
    k = centroids.shape[1]
    dev = x.device
    rechecks = torch.zeros((b, -(-n // SCREEN_BLOCK_POINTS)), dtype=torch.int32, device=dev)
    out = torch.empty((b, n, k), dtype=torch.float32, device=dev) if screen else None
    best = torch.empty((b, n), dtype=torch.float32, device=dev)
    assign = _batched(x, centroids, True, rechecks, out, best)
    return Probe(assign, rechecks, out, best)


def kmeans_assign_narrow_probe(
    x: torch.Tensor, centroids: torch.Tensor, *, screen: bool = False
) -> Probe:
    """The narrow kernel (``s <= 64``, its block within shared memory) on
    ``x: (B, n, s)``, ``centroids: (B, k, s)`` with its instruments on: the
    re-checked pairs of each block (a point the screen does not settle
    counts ``k``), each point's plain best distance, and with ``screen``
    every screen value ``t_j = x.c_j - |c_j|^2 / 2`` (the screen distance is
    ``|x|^2 - 2 t_j``).  For the checks only."""
    b, n, _ = x.shape
    k = centroids.shape[1]
    dev = x.device
    # the kernel's blocks take at least 1,024 points: room for every block
    rechecks = torch.zeros((b, -(-n // 1024)), dtype=torch.int32, device=dev)
    out = torch.empty((b, n, k), dtype=torch.float32, device=dev) if screen else None
    best = torch.empty((b, n), dtype=torch.float32, device=dev)
    assign = _batched(x, centroids, False, rechecks, out, best)
    return Probe(assign, rechecks, out, best)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    global assign_launches
    n, s = x.shape
    k = centroids.shape[0]
    dev = x.device
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    norms = torch.empty((k + 1,), dtype=torch.float32, device=dev)
    fn = _build.entry("kmeans_assign", "kmeans_assign", _ASSIGN_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), centroids.data_ptr(), n, k, s, screen_margin(s), norms.data_ptr(),
            assign.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("kmeans_assign", rc, "kmeans_assign")
    assign_launches += 1
    return assign
