"""Batched K-means (the paper's Algorithm 2 building block) and the
K-means library around it: the counterpart of ``repro.core.kmeans``.

Three ways to train, one update rule (``c <- sums / max(counts, 1)``; an
empty cluster keeps its centroid):

* **dense** (``block_n=0``): full-batch Lloyd.  On the CPU each step is
  :func:`_lloyd_step`, the ``(B, n, k)`` reference; on the card the
  Lloyd-statistics kernel runs over chunks of its own choosing
  (:data:`CARD_BLOCK_N`).  The two differ only in summation order, as the
  JAX package lets its dense and kernel routes differ.
* **chunked** (``block_n>0``, ``algo="lloyd"``): each step is one
  statistics pass over ``block_n``-point chunks
  (:func:`repro_torch.kernels.kmeans_assign.ops.kmeans_stats`: the CUDA
  kernel on the card, :func:`lloyd_stats_scan` on the CPU).
* **minibatch** (``algo="minibatch"``): each of ``iters`` steps takes one
  shared sample of ``block_n`` points and moves each centroid by Sculley's
  per-centroid rate ``counts / cnts``; the final assignment then reports
  the full-data inertia.

The final assignment (:func:`_final_assign`) takes the pair kernel when
SuCo's paired layout asks for the IMI histogram (``pair_sqrt_k > 0``), the
batched assignment kernel when nothing else is needed, and the statistics
kernel with its assignments when the inertia is (minibatch), with the
histogram then counted by an integer bincount.  :func:`assign` (one
problem, any width) is its own kernel.

Random draws come from a ``torch.Generator`` (on the CPU, so a seed gives
the same draws whatever the device): distinct random rows, or kmeans++ D^2
seeding over a uniform sample.  The two RNGs differ from JAX's, so the
tests inject the JAX package's draws through ``init_centroids=`` and
``sample_idx=``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distances import sqdist_rowwise
from repro_torch.core.spans import loop_span
from repro_torch.kernels.kmeans_assign.ops import (
    kmeans_assign,
    kmeans_assign_batched,
    kmeans_pair_assign_hist,
    kmeans_stats,
)
from repro_torch.kernels.kmeans_assign.ref import assign_scan, block_batched, lloyd_stats_scan

__all__ = [
    "KMeansResult",
    "kmeans",
    "kmeans_batched",
    "assign",
    "block_batched",
    "lloyd_stats_scan",
    "assign_scan",
    "init_random",
    "init_centroids_pp",
    "pair_cell_counts",
    "CARD_BLOCK_N",
]

_ALGOS = ("lloyd", "minibatch")
_INITS = ("auto", "random", "kmeans++")
_MINIBATCH_DEFAULT_BLOCK = 4096
# kmeans++ seeds from a uniform sample of this many points (capped at n)
_PP_SAMPLE_PER_K = 32
_PP_SAMPLE_MIN = 2048
#: chunk of points the kernels take on the card when the caller asks for the
#: dense mode (``block_n=0``)
CARD_BLOCK_N = 4096


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, s) — or (B, k, s) batched
    assignments: torch.Tensor  # (n,) int32 — or (B, n) batched
    # () — or (B,): Lloyd reports the last update step's inertia, minibatch
    # the full-data inertia of its final assignment
    inertia: torch.Tensor
    cell_counts: torch.Tensor | None = None  # (B//2, pair_sqrt_k**2) int32 when paired


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """``argmin_c ||x - centroid_c||^2`` for every row of ``x: (n, s)``
    against ``centroids: (k, s)`` -> ``(n,)`` int32, lowest index on ties;
    any width, any ``k``."""
    return kmeans_assign(x.float().contiguous(), centroids.float().contiguous())


def init_random(xs: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """``(B, n, s) -> (B, k, s)``: ``k`` distinct random rows per codebook.

    The permutations are drawn on the CPU from ``generator``, so a seed gives
    the same rows whatever device ``xs`` lies on."""
    b, n, _ = xs.shape
    if k > n:
        raise ValueError(f"k={k} centroids need at least k points, got n={n}")
    idx = torch.stack([torch.randperm(n, generator=generator)[:k] for _ in range(b)])
    idx = idx.to(xs.device)
    return torch.gather(xs, 1, idx[:, :, None].expand(b, k, xs.shape[2]))


def _init_pp_batched(
    xs: torch.Tensor, k: int, sample_n: int, generator: torch.Generator
) -> torch.Tensor:
    """kmeans++ D^2 seeding of every codebook of ``xs: (B, n, s)`` at once,
    each over its own uniform sample of ``sample_n`` rows (all rows when
    ``sample_n`` is 0 or >= n) -> ``(B, k, s)``.

    Each seed after the first is drawn with probability proportional to
    D^2, the squared distance to the nearest seed so far, by inverting the
    cumulative D^2 at a uniform draw; a sample whose D^2 is all zero draws
    uniformly.  The uniforms and the sample come from ``generator`` on the
    CPU; the distances stay on ``xs``'s device, with no host sync."""
    b, n, s = xs.shape
    dev = xs.device
    if 0 < sample_n < n:
        idx = torch.stack([torch.randperm(n, generator=generator)[:sample_n] for _ in range(b)])
        xf = torch.gather(xs, 1, idx.to(dev)[:, :, None].expand(b, sample_n, s)).float()
    else:
        xf = xs.float()
    m = xf.shape[1]
    first = torch.randint(0, m, (b,), generator=generator).to(dev)
    u = torch.rand((k - 1, b, 1), generator=generator, dtype=torch.float64).to(dev)
    rows = torch.arange(b, device=dev)
    c = xf[rows, first]  # (B, s)
    cents = [c]
    d2 = ((xf - c[:, None, :]) ** 2).sum(-1)  # (B, m)
    for i in range(k - 1):
        w = d2.double()
        total = w.sum(dim=1, keepdim=True)
        w = torch.where(total > 0, w, torch.ones_like(w))
        cdf = torch.cumsum(w, dim=1)
        pick = torch.searchsorted(cdf, u[i] * cdf[:, -1:], right=True).clamp_max(m - 1)[:, 0]
        c = xf[rows, pick]
        cents.append(c)
        d2 = torch.minimum(d2, ((xf - c[:, None, :]) ** 2).sum(-1))
    return torch.stack(cents, dim=1).to(xs.dtype)


def init_centroids_pp(
    x: torch.Tensor, k: int, *, sample_n: int = 0, generator: torch.Generator
) -> torch.Tensor:
    """kmeans++-style D^2 seeding (Arthur & Vassilvitskii) of ``x: (n, s)``
    -> ``(k, s)`` over a uniform sample of ``sample_n`` rows (all of ``x``
    when 0).  O(sample_n * k) work; deterministic given ``generator``."""
    return _init_pp_batched(x[None], k, sample_n, generator)[0]


def _init_batched(
    xs: torch.Tensor, k: int, init: str, algo: str, generator: torch.Generator
) -> torch.Tensor:
    """``(B, n, s) -> (B, k, s)`` initial centroids for every problem.
    ``init="auto"`` is kmeans++ for minibatch (a few sampled steps cannot
    recover from a bad random seed as full Lloyd epochs can), random for
    Lloyd (the paper's choice)."""
    if init == "auto":
        init = "kmeans++" if algo == "minibatch" else "random"
    if init == "random":
        return init_random(xs, k, generator)
    n = xs.shape[1]
    return _init_pp_batched(xs, k, min(n, max(_PP_SAMPLE_PER_K * k, _PP_SAMPLE_MIN)), generator)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def _lloyd_step(xs: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One dense Lloyd step over ``xs: (B, n, s)``: the reference every
    chunked path must match (it holds the ``(B, n, k)`` distances) ->
    ``(new centroids (B, k, s), inertia (B,))``."""
    b, n, s = xs.shape
    k = c.shape[1]
    d2 = sqdist_rowwise(xs, c)
    a = torch.argmin(d2, dim=2)
    flat = (a + (torch.arange(b, device=xs.device) * k)[:, None]).reshape(-1)
    sums = torch.zeros((b * k, s), dtype=torch.float32, device=xs.device)
    sums.index_add_(0, flat, xs.float().reshape(-1, s))
    counts = torch.bincount(flat, minlength=b * k).float()
    inertia = d2.gather(2, a[..., None])[..., 0].sum(dim=1)
    return _update(c, sums.reshape(b, k, s), counts.reshape(b, k)), inertia


def _update(c: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    new = sums / torch.clamp(counts, min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, new, c).contiguous()


def pair_cell_counts(a: torch.Tensor, sqrt_k: int) -> torch.Tensor:
    """IMI occupancy of SuCo's paired assignments ``a: (2Ns, n)`` ->
    ``(Ns, sqrt_k**2)`` int32, by an integer bincount (no host sync)."""
    ns = a.shape[0] // 2
    kk = sqrt_k * sqrt_k
    cells = a[:ns].long() * sqrt_k + a[ns:].long()
    cells = cells + (torch.arange(ns, device=a.device) * kk)[:, None]
    counts = torch.zeros(ns * kk, dtype=torch.int32, device=a.device)
    counts.index_add_(0, cells.reshape(-1), torch.ones_like(cells, dtype=torch.int32).reshape(-1))
    return counts.reshape(ns, kk)


def _final_assign(
    xs: torch.Tensor, c: torch.Tensor, *, block_n: int, need_inertia: bool, pair_sqrt_k: int
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Final assignment pass over ``block_n``-point chunks -> ``(assign
    (B, n) int32, inertia (B,) | None, cell_counts | None)``: the pair
    kernel when paired, the batched assignment kernel when nothing else is
    needed, the statistics kernel (with its assignments) when the inertia
    is."""
    if not need_inertia:
        if pair_sqrt_k:
            a, counts = kmeans_pair_assign_hist(xs, c, block_n=block_n)
            return a, None, counts
        return kmeans_assign_batched(xs, c, block_n=block_n), None, None
    a, _, _, inertia = kmeans_stats(xs, c, block_n=block_n, with_assign=True)
    return a, inertia, pair_cell_counts(a, pair_sqrt_k) if pair_sqrt_k else None


def _kmeans_core(
    xs: torch.Tensor,
    c0: torch.Tensor,
    iters: int,
    algo: str,
    block_n: int,
    pair_sqrt_k: int,
    generator: torch.Generator | None,
    sample_idx: torch.Tensor | None,
) -> KMeansResult:
    b, n, _ = xs.shape
    k = c0.shape[1]
    c = c0
    if algo == "minibatch":
        bn = max(1, min(block_n or _MINIBATCH_DEFAULT_BLOCK, n))
        if sample_idx is not None and tuple(sample_idx.shape) != (iters, bn):
            raise ValueError(f"sample_idx must be {(iters, bn)}, got {tuple(sample_idx.shape)}")
        cnts = torch.zeros((b, k), dtype=torch.float32, device=xs.device)
        for t in range(iters):
            with loop_span("kmeans.minibatch_step"):
                idx = (sample_idx[t] if sample_idx is not None
                       else torch.randint(0, n, (bn,), generator=generator))
                xb = xs[:, idx.to(device=xs.device, dtype=torch.long)].contiguous()  # shared sample
                _, sums, counts, _ = kmeans_stats(xb, c, block_n=bn)
                cnts = cnts + counts
                # Sculley's update aggregated over the sample: per-centroid rate
                # counts / cnts, c <- c + (sums - counts * c) / cnts
                c = (c + (sums - counts[..., None] * c) / torch.clamp(cnts, min=1.0)[..., None])
                c = c.contiguous()
        a, inertia, cell_counts = _final_assign(
            xs, c, block_n=bn, need_inertia=True, pair_sqrt_k=pair_sqrt_k
        )
        return KMeansResult(c, a, inertia, cell_counts)

    # dense: the (B, n, k) reference step on the CPU; on the card the
    # kernels over chunks of their own size
    cpu = xs.device.type == "cpu"
    chunk = block_n or (n if cpu else CARD_BLOCK_N)
    inertia = torch.zeros(b, dtype=torch.float32, device=xs.device)
    for _ in range(iters):
        with loop_span("kmeans.lloyd_step"):
            if block_n == 0 and cpu:
                c, inertia = _lloyd_step(xs, c)
            else:
                _, sums, counts, inertia = kmeans_stats(xs, c, block_n=chunk)
                c = _update(c, sums, counts)
    a, _, cell_counts = _final_assign(
        xs, c, block_n=chunk, need_inertia=False, pair_sqrt_k=pair_sqrt_k
    )
    return KMeansResult(c, a, inertia, cell_counts)


def _check_args(algo: str, block_n: int, init: str = "auto") -> None:
    if algo not in _ALGOS:
        raise ValueError(f"algo must be one of {_ALGOS}, got {algo!r}")
    if block_n < 0:
        raise ValueError(f"block_n must be >= 0 (0 = dense), got {block_n}")
    if init not in _INITS:
        raise ValueError(f"init must be one of {_INITS}, got {init!r}")


def _needs_generator(generator, init_centroids, algo, sample_idx) -> None:
    if generator is None and (
        init_centroids is None or (algo == "minibatch" and sample_idx is None)
    ):
        raise ValueError("pass a generator, or init_centroids (and sample_idx for minibatch)")


def kmeans_batched(
    xs: torch.Tensor,
    k: int,
    iters: int,
    *,
    algo: str = "lloyd",
    block_n: int = 0,
    init: str = "auto",
    pair_sqrt_k: int = 0,
    generator: torch.Generator | None = None,
    init_centroids: torch.Tensor | None = None,
    sample_idx: torch.Tensor | None = None,
) -> KMeansResult:
    """``xs: (B, n, s)`` -> centroids ``(B, k, s)``, assignments ``(B, n)``
    int32, for all ``B`` codebooks at once (B = 2*Ns for SuCo), on the
    device ``xs`` lies on.

    ``algo``: "lloyd" | "minibatch".  ``block_n``: 0 = dense Lloyd, > 0 =
    chunks of ``block_n`` points (the minibatch sample size; 0 there means
    4096).  ``init``: "random" | "kmeans++" | "auto" (kmeans++ for
    minibatch, random for Lloyd).  ``pair_sqrt_k > 0`` reads the batch as
    SuCo's paired layout and also returns the IMI occupancy
    ``cell_counts (B//2, pair_sqrt_k**2)``; 0 leaves it ``None``.

    Draws come from ``generator``; the test hooks ``init_centroids: (B, k,
    s)`` and ``sample_idx: (iters, bn)`` (the minibatch samples) replace
    them.
    """
    _check_args(algo, block_n, init)
    _needs_generator(generator, init_centroids, algo, sample_idx)
    if init_centroids is None:
        c0 = _init_batched(xs, k, init, algo, generator)
    else:
        c0 = init_centroids.to(device=xs.device, dtype=torch.float32).contiguous()
        if c0.shape != (xs.shape[0], k, xs.shape[2]):
            raise ValueError(
                f"init_centroids must be {(xs.shape[0], k, xs.shape[2])}, got {tuple(c0.shape)}"
            )
    xs = xs.float().contiguous()
    return _kmeans_core(xs, c0.float().contiguous(), iters, algo, block_n, pair_sqrt_k,
                        generator, sample_idx)


def kmeans(
    x: torch.Tensor,
    k: int,
    iters: int,
    *,
    algo: str = "lloyd",
    block_n: int = 0,
    init: str = "auto",
    generator: torch.Generator | None = None,
    init_centroids: torch.Tensor | None = None,
    sample_idx: torch.Tensor | None = None,
) -> KMeansResult:
    """K-means of one problem ``x: (n, s)`` with ``iters`` update steps:
    :func:`kmeans_batched` at B = 1 (the same contract; ``init_centroids``
    is ``(k, s)``), whose final assignment takes the batched assignment
    kernel.  Returns centroids ``(k, s)``, assignments ``(n,)`` and the
    inertia ``()``."""
    res = kmeans_batched(
        x[None], k, iters, algo=algo, block_n=block_n, init=init, generator=generator,
        init_centroids=None if init_centroids is None else init_centroids[None],
        sample_idx=sample_idx,
    )
    return KMeansResult(res.centroids[0], res.assignments[0], res.inertia[0])
