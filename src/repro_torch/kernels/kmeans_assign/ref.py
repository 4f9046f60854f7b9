"""Plain PyTorch versions of the K-means passes: nearest-centroid
assignment (single and batched), Lloyd statistics, and the paired final
assignment with the IMI occupancy histogram.

Distances are summed one dim at a time (:func:`repro_torch.core.distances.
sqdist_rowwise`), the arithmetic of the CUDA kernels, so the assignments
of the two agree exactly.  The data is processed in chunks of ``block_n``
points, which bounds the ``(B, block_n, k)`` distance block: the JAX
package's chunking helpers :func:`block_batched`, :func:`lloyd_stats_scan`
and :func:`assign_scan` (``repro.core.kmeans``), which every plain version
here is written on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distances import sqdist_rowwise

#: chunk of points of the single-problem plain assignment
ASSIGN_BLOCK_N = 4096


def block_batched(xs: torch.Tensor, block_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, n, s) -> (blocks (nb, B, bn, s), valid (nb, bn) bool)``:
    ``n`` zero-padded up to a multiple of ``bn = min(block_n, n)``;
    ``valid`` masks the padded tail."""
    b, n, s = xs.shape
    bn = max(1, min(block_n, n))
    nb = -(-n // bn)
    xp = F.pad(xs, (0, 0, 0, nb * bn - n)) if nb * bn != n else xs
    blocks = xp.reshape(b, nb, bn, s).transpose(0, 1)
    valid = (torch.arange(nb * bn, device=xs.device) < n).reshape(nb, bn)
    return blocks, valid


def _nearest(xb: torch.Tensor, centroids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, bn, s), (B, k, s) -> (assign (B, bn) int64, best distance
    (B, bn) f32)``; ties to the lowest centroid index."""
    d2 = sqdist_rowwise(xb, centroids)
    a = torch.argmin(d2, dim=2)
    return a, d2.gather(2, a[..., None])[..., 0]


def _stats_scan(
    blocks: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd pass over the blocks -> ``(assign (B, nb*bn) int32, sums
    (B, k, s), counts (B, k), inertia (B,))``, padded points weighted 0."""
    _, b, bn, s = blocks.shape
    k = centroids.shape[1]
    dev = blocks.device
    sums = torch.zeros((b * k, s), dtype=torch.float32, device=dev)
    counts = torch.zeros((b * k,), dtype=torch.float32, device=dev)
    inertia = torch.zeros((b,), dtype=torch.float32, device=dev)
    base = (torch.arange(b, device=dev) * k)[:, None]
    assign = []
    for xb, vb in zip(blocks, valid):
        xb = xb.float()
        a, best = _nearest(xb, centroids)
        w = vb.float()
        flat = (a + base).reshape(-1)
        sums.index_add_(0, flat, xb.reshape(-1, s))  # padded rows are zeros
        counts.index_add_(0, flat, w.expand(b, bn).reshape(-1))
        inertia += (best * w).sum(dim=1)
        assign.append(a.to(torch.int32))
    return torch.cat(assign, dim=1), sums.reshape(b, k, s), counts.reshape(b, k), inertia


def lloyd_stats_scan(
    blocks: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd assignment pass over ``blocks: (nb, B, bn, s)`` with the
    ``valid: (nb, bn)`` mask -> ``(sums (B, k, s), counts (B, k), inertia
    (B,))`` f32.  Only a ``(B, bn, k)`` distance block is live at a time."""
    return _stats_scan(blocks, valid, centroids)[1:]


def assign_scan(
    blocks: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor, *, pair_sqrt_k: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Chunked final assignment -> ``(assign (B, nb*bn) int32, inertia (B,),
    cell_counts (B//2, pair_sqrt_k**2) int32 | None)``.

    Assignments of padded rows are junk (the caller slices ``[:, :n]``);
    the inertia and the histogram count valid rows only.  ``pair_sqrt_k >
    0`` reads the batch as SuCo's paired layout (rows ``[:B//2]`` first
    halves, ``[B//2:]`` second halves) and counts the IMI cells
    ``a1 * pair_sqrt_k + a2`` per subspace."""
    _, b, _, _ = blocks.shape
    if pair_sqrt_k and b % 2:
        raise ValueError(f"pair_sqrt_k needs an even batch, got B={b}")
    ns = b // 2
    dev = blocks.device
    cells_total = ns * pair_sqrt_k * pair_sqrt_k
    counts = torch.zeros((cells_total,), dtype=torch.int64, device=dev)
    inertia = torch.zeros((b,), dtype=torch.float32, device=dev)
    offsets = (torch.arange(ns, device=dev) * pair_sqrt_k * pair_sqrt_k)[:, None]
    assign = []
    for xb, vb in zip(blocks, valid):
        a, best = _nearest(xb.float(), centroids)
        inertia += (best * vb.float()).sum(dim=1)
        if pair_sqrt_k:
            cells = (a[:ns] * pair_sqrt_k + a[ns:] + offsets)[:, vb]
            counts += torch.bincount(cells.reshape(-1), minlength=cells_total)
        assign.append(a.to(torch.int32))
    hist = counts.reshape(ns, -1).to(torch.int32) if pair_sqrt_k else None
    return torch.cat(assign, dim=1), inertia, hist


def kmeans_stats_ref(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x: (B, n, s)``, ``centroids: (B, k, s)`` -> ``(assign (B, n) int32,
    sums (B, k, s) f32, counts (B, k) f32, inertia (B,) f32)``: each point's
    nearest centroid (lowest index on ties) and the per-centroid sums, counts
    and squared distances."""
    a, sums, counts, inertia = _stats_scan(*block_batched(x, block_n), centroids)
    return a[:, : x.shape[1]], sums, counts, inertia


def kmeans_pair_assign_hist_ref(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``x: (2Ns, n, s)``, ``centroids: (2Ns, k, s)`` in SuCo's paired
    half-subspace layout -> ``(assign (2Ns, n) int32, cell_counts (Ns, k*k)
    int32)``, with ``cell_counts[i, a1*k + a2]`` the occupancy of each IMI
    cell of subspace i."""
    a, _, counts = assign_scan(
        *block_batched(x, block_n), centroids, pair_sqrt_k=centroids.shape[1]
    )
    return a[:, : x.shape[1]], counts


def kmeans_assign_batched_ref(
    x: torch.Tensor, centroids: torch.Tensor, *, block_n: int
) -> torch.Tensor:
    """``x: (B, n, s)``, ``centroids: (B, k, s)`` -> ``(B, n)`` int32: each
    point's nearest centroid of its codebook, lowest index on ties."""
    return assign_scan(*block_batched(x, block_n), centroids)[0][:, : x.shape[1]]


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """``x: (n, s)``, ``centroids: (k, s)`` -> ``(n,)`` int32: each point's
    nearest centroid, lowest index on ties; chunks of
    :data:`ASSIGN_BLOCK_N` points."""
    return kmeans_assign_batched_ref(x[None], centroids[None], block_n=ASSIGN_BLOCK_N)[0]
