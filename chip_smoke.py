#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (``--seed S`` picks
the data).  It builds the CUDA kernels from ``src/repro_torch/csrc``, then
drives three paths over SIFT1M's shape (n = 1,000,000, d = 128, data from
``gaussian_mixture``), each with every kernel's launch count set to 0 just
before it and read just after:

* ``main_path``: build a SuCo index with the default ``SuCoConfig`` and serve
  batches of 1, 8 and 64 queries through ``SuCoEngine`` (fused mode);
* ``query_modes``: the same batches through ``suco_query``'s dense and
  streaming modes (engines over the same index), each answer held against
  the fused one;
* ``sc_linear``: SC-Linear (Algorithm 1, ``sc_linear_query``) at Ns = 8 on
  batches of 8 and 64.

It checks recall@10 against an exact k-NN, answers 8 queries of the fused
and SC-Linear paths again on the CPU with the plain versions, and holds each
kernel against its plain PyTorch version at the shapes of its path.

Output: one JSON line per phase; then a ``{"kernels": [...]}`` line (per
kernel: its launches on its path, its error against the plain version, its
time, the plain version's time, the card's bound for the same work, and a
library call's time where one PyTorch call computes the same function); then
``nvidia-smi``'s name and power limit; last, ``{"ok": true, "device": ...}``.
Any failure raises, exits non-zero and prints no last line.  Without a CUDA
card, or outside a checkout of the repository, it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA cores, fp32 (also taken for 32-bit int ops)
SOURCES = {
    "sc_score_cells_prefilter_compact": (
        "src/repro_torch/csrc/sc_score.cu", "src/repro/kernels/sc_score/kernel.py:151"),
    "gather_rerank": (
        "src/repro_torch/csrc/gather_rerank.cu", "src/repro/kernels/gather_rerank/kernel.py:35"),
    "kmeans_stats": (
        "src/repro_torch/csrc/kmeans_assign.cu", "src/repro/kernels/kmeans_assign/kernel.py:252"),
    "kmeans_pair_assign_hist": (
        "src/repro_torch/csrc/kmeans_assign.cu", "src/repro/kernels/kmeans_assign/kernel.py:154"),
    "sc_score_cells": (
        "src/repro_torch/csrc/sc_score.cu", "src/repro/kernels/sc_score/kernel.py:263"),
    "sc_score_cells_prefilter": (
        "src/repro_torch/csrc/sc_score.cu", "src/repro/kernels/sc_score/kernel.py:218"),
    "sc_score": (
        "src/repro_torch/csrc/pairwise_l2.cu", "src/repro/kernels/sc_score/kernel.py:303"),
    "pairwise_sqdist": (
        "src/repro_torch/csrc/pairwise_l2.cu", "src/repro/kernels/pairwise_l2/kernel.py:49"),
}
#: the path whose launches each kernel reports (the prefilter kernel is on no
#: path: only its public op and the kernel checks call it)
PATH_OF = {
    "sc_score_cells_prefilter_compact": "main_path", "gather_rerank": "main_path",
    "kmeans_stats": "main_path", "kmeans_pair_assign_hist": "main_path",
    "sc_score_cells": "query_modes", "sc_score": "sc_linear", "pairwise_sqdist": "sc_linear",
}


def check_launched(path: str, counts: dict) -> None:
    """Fail unless every kernel of ``path`` launched in its run."""
    missing = [name for name, p in PATH_OF.items() if p == path and counts[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate, in ms."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_kernels(dev, data, both, c0, index, q64, cfg, tiles) -> dict:
    """Each kernel against its plain version on the same inputs, at the main
    path's shapes.  Integers must be equal; floats within the stated
    tolerance.  Returns per-kernel records for the ``kernels`` line."""
    import torch

    from repro_torch.core import subspace as sub
    from repro_torch.core.suco import suco_cell_ranks
    from repro_torch.kernels.gather_rerank import ops as gather_ops
    from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.kmeans_assign.ref import (
        kmeans_pair_assign_hist_ref,
        kmeans_stats_ref,
    )
    from repro_torch.kernels.sc_score import ops as score_ops
    from repro_torch.kernels.sc_score.ref import sc_score_cells_prefilter_compact_ref

    out = {}
    b, n, s = both.shape
    k = cfg.sqrt_k
    bn = cfg.block_n

    # kmeans_stats: one Lloyd pass over the 2*Ns codebooks from the seeds
    got = kmeans_ops.kmeans_stats(both, c0, block_n=bn, with_assign=True)
    want = kmeans_stats_ref(both, c0, block_n=bn)
    a, sums, counts, inertia = got
    if not (torch.equal(a, want[0]) and torch.equal(counts, want[2])):
        raise AssertionError("kmeans_stats: assignments or counts differ from the plain version")
    onehot_mag = torch.zeros((b * k, s), dtype=torch.float64, device=dev)
    onehot_mag.index_add_(0, (a.long() + torch.arange(b, device=dev)[:, None] * k).reshape(-1),
                          both.abs().double().reshape(-1, s))
    err_sums = (sums.double() - want[1].double()).abs()
    if not (err_sums <= 1e-5 * onehot_mag.reshape(b, k, s)).all():
        raise AssertionError("kmeans_stats: sums outside 1e-5 * sum |terms|")
    err_in = (inertia.double() - want[3].double()).abs()
    if not (err_in <= 1e-5 * want[3].double()).all():
        raise AssertionError("kmeans_stats: inertia outside 1e-5 relative")
    t_ops = 3.0 * b * n * k * s
    bms, by = bound(nbytes(both, c0, sums, counts, inertia), t_ops)
    out["kmeans_stats"] = dict(
        max_abs_err=float(err_sums.max()),
        ms=time_ms(lambda: kmeans_ops.kmeans_stats(both, c0, block_n=bn), 10),
        plain_ms=time_ms(lambda: kmeans_stats_ref(both, c0, block_n=bn), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=[b, n, s], k=k, block_n=bn, inertia_max_rel_err=float(
            (err_in / want[3].double()).max()),
            # dynamic shared memory per block (centroids, accumulators, one tile)
            smem_bytes=4 * (k * s + k * (s + 1) + 256 * (s + 2))),
    )

    # kmeans_pair_assign_hist: the final assignment with the built centroids
    cents = torch.cat([index.centroids1, index.centroids2]).contiguous()
    got = kmeans_ops.kmeans_pair_assign_hist(both, cents, block_n=bn)
    want = kmeans_pair_assign_hist_ref(both, cents, block_n=bn)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("kmeans_pair_assign_hist differs from the plain version")
    bms, by = bound(nbytes(both, cents, *got), 3.0 * b * n * k * s)
    out["kmeans_pair_assign_hist"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: kmeans_ops.kmeans_pair_assign_hist(both, cents, block_n=bn), 10),
        plain_ms=time_ms(lambda: kmeans_pair_assign_hist_ref(both, cents, block_n=bn), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=[b, n, s], k=k, block_n=bn,
                    smem_bytes=4 * (2 * k * s + k * k)),  # both codebooks + histogram
    )

    # sc_score compact: one chunk of the 64-query batch, with and without a
    # tombstone mask; the threshold of a warm pool (score > Ns/2 survives)
    m = q64.shape[0]
    ranks, cuts = suco_cell_ranks(index, q64, sub.collision_count(n, 0.05))
    chunk = tiles.block_n
    cells = index.cell_ids[:, :chunk]
    thr = torch.full((m,), cfg.n_subspaces // 2, dtype=torch.int32, device=dev)
    keep = torch.rand(chunk, device=dev, generator=torch.Generator(dev).manual_seed(0)) > 0.1
    cap = tiles.survivor_cap
    for kc in (keep, None):
        got = score_ops.sc_scores_cells_prefilter_compact(ranks, cuts, cells, thr, chunk, kc, cap=cap)
        want = sc_score_cells_prefilter_compact_ref(ranks, cuts, cells, thr, chunk, kc, cap=cap)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("sc_score compact differs from the plain version")
    bms, by = bound(nbytes(ranks, cuts, cells, thr, *got), 2.0 * cfg.n_subspaces * m * chunk)
    out["sc_score_cells_prefilter_compact"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: score_ops.sc_scores_cells_prefilter_compact(
            ranks, cuts, cells, thr, chunk, cap=cap), 50),
        plain_ms=time_ms(lambda: sc_score_cells_prefilter_compact_ref(
            ranks, cuts, cells, thr, chunk, cap=cap), 10),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, chunk=chunk, cap=cap, ns=cfg.n_subspaces, cells=index.n_cells,
                    smem_bytes=4 * cfg.n_subspaces * -(-index.n_cells // 32),  # the bitmap
                    mean_survivors=float(got[3].float().mean())),
    )

    # gather_rerank: a compaction buffer of candidates per query
    ids = torch.randint(0, n, (m, cap), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(1))
    got = gather_ops.gather_rerank_block(ids, data, q64)
    want = gather_rerank_block_ref(ids, data, q64)
    err = (got - want).abs()
    if not (err <= 2e-5 * want.abs()).all():
        raise AssertionError("gather_rerank outside rtol 2e-5 of the plain version")
    d = data.shape[1]
    rows = m * cap * d * 4
    bms, by = bound(nbytes(ids, q64, got) + rows, 3.0 * m * cap * d)
    out["gather_rerank"] = dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: gather_ops.gather_rerank_block(ids, data, q64), 50),
        plain_ms=time_ms(lambda: gather_rerank_block_ref(ids, data, q64), 20),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, candidates=cap, d=d),
    )
    return out


def dist_ops(m: int, n: int, s: int) -> float:
    """fp32 operations of the (m, n) pairwise distances at width s: per
    output s multiplies and s adds for the cross term, then add, double,
    subtract and clamp; per row 2s for its norm."""
    return m * n * (2.0 * s + 4) + (m + n) * 2.0 * s


def check_query_kernels(dev, data, index, q64, cfg, tiles) -> dict:
    """The kernels of the query modes and SC-Linear against their plain
    versions at their paths' shapes: the scores-only kernel at m = 64 over
    one streaming chunk of 4096 points, the keep-mask kernel over one fused
    chunk, and the pairwise and fused-score kernels at m = 64 over all n
    points of one subspace (of all Ns).  Every output must be equal."""
    import torch

    from repro_torch.core import subspace as sub
    from repro_torch.core.collision import kth_smallest
    from repro_torch.core.suco import suco_cell_ranks
    from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
    from repro_torch.kernels.pairwise_l2.ref import pairwise_sqdist_ref
    from repro_torch.kernels.sc_score import ops as score_ops
    from repro_torch.kernels.sc_score.ref import (
        sc_score_cells_prefilter_ref,
        sc_score_cells_ref,
        sc_score_ref,
    )

    out = {}
    n = data.shape[0]
    m, ns = q64.shape[0], cfg.n_subspaces
    ranks, cuts = suco_cell_ranks(index, q64, sub.collision_count(n, 0.05))

    # scores only: one streaming chunk
    cells = index.cell_ids[:, :4096]
    got = score_ops.sc_scores_cells(ranks, cuts, cells)
    if not torch.equal(got, sc_score_cells_ref(ranks, cuts, cells)):
        raise AssertionError("sc_score_cells differs from the plain version")
    bms, by = bound(nbytes(ranks, cuts, cells, got), 2.0 * ns * m * cells.shape[1])
    out["sc_score_cells"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: score_ops.sc_scores_cells(ranks, cuts, cells), 100),
        plain_ms=time_ms(lambda: sc_score_cells_ref(ranks, cuts, cells), 20),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, chunk=cells.shape[1], ns=ns, cells=index.n_cells),
    )

    # scores + keep mask: one fused chunk, the threshold of a warm pool
    cells = index.cell_ids[:, : tiles.block_n]
    thr = torch.full((m,), ns // 2, dtype=torch.int32, device=dev)
    got_s, got_k = score_ops.sc_scores_cells_prefilter(ranks, cuts, cells, thr)
    want_s, want_k = sc_score_cells_prefilter_ref(ranks, cuts, cells, thr)
    if not (torch.equal(got_s, want_s) and torch.equal(got_k, want_k)):
        raise AssertionError("sc_score_cells_prefilter differs from the plain version")
    if not (torch.equal(got_s, score_ops.sc_scores_cells(ranks, cuts, cells))
            and torch.equal(got_k, got_s > thr[:, None])):
        raise AssertionError("sc_score_cells_prefilter: scores or keep disagree with sc_score_cells")
    bms, by = bound(nbytes(ranks, cuts, cells, thr, got_s, got_k),
                    (2.0 * ns + 1) * m * cells.shape[1])
    out["sc_score_cells_prefilter"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: score_ops.sc_scores_cells_prefilter(ranks, cuts, cells, thr), 100),
        plain_ms=time_ms(lambda: sc_score_cells_prefilter_ref(ranks, cuts, cells, thr), 20),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, chunk=cells.shape[1], ns=ns, kept=float(got_k.float().mean())),
    )

    # pairwise distances: one subspace of SC-Linear (strided views, no copy)
    spec = sub.contiguous_spec(data.shape[1], ns)
    xs, qs = sub.split_padded(spec, data), sub.split_padded(spec, q64)
    s = xs.shape[2]
    got = pairwise_ops.pairwise_sqdist(qs[0], xs[0])
    want = pairwise_sqdist_ref(qs[0], xs[0])
    if not torch.equal(got, want):
        raise AssertionError("pairwise_sqdist differs from the plain version")
    del want
    q0, x0 = qs[0].contiguous(), xs[0].contiguous()  # cdist wants dense operands
    bms, by = bound(nbytes(qs[0], xs[0], got), dist_ops(m, n, s))
    out["pairwise_sqdist"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: pairwise_ops.pairwise_sqdist(qs[0], xs[0]), 20),
        plain_ms=time_ms(lambda: pairwise_sqdist_ref(qs[0], xs[0]), 3, warmup=1),
        bound_ms=bms, bound_by=by,
        # torch.cdist through its matmul form, squared: one PyTorch call (and
        # a square) for the same function, with TF32 off
        library_ms=time_ms(
            lambda: torch.cdist(q0, x0, compute_mode="use_mm_for_euclid_dist") ** 2, 20),
        detail=dict(m=m, n=n, s=s, library="torch.cdist(use_mm_for_euclid_dist) ** 2",
                    library_max_abs_err=float(
                        (torch.cdist(q0, x0, compute_mode="use_mm_for_euclid_dist") ** 2
                         - got).abs().max())),
    )
    del q0, x0

    # fused scores: SC-Linear's own thresholds, from the pairwise kernel's
    # distances; the counts must be those distances' collisions exactly
    count = sub.collision_count(n, 0.05)
    tau = torch.stack([kth_smallest(pairwise_ops.pairwise_sqdist(qs[i], xs[i]), count)
                       for i in range(ns)])
    got = score_ops.sc_scores_fused(qs, xs, tau)
    if not torch.equal(got, sc_score_ref(qs, xs, tau)):
        raise AssertionError("sc_score differs from the plain version")
    on_path = torch.zeros_like(got)
    for i in range(ns):
        on_path += pairwise_ops.pairwise_sqdist(qs[i], xs[i]) <= tau[i][:, None]
    if not torch.equal(got, on_path):
        raise AssertionError("sc_score disagrees with the collisions of pairwise_sqdist")
    del on_path
    bms, by = bound(nbytes(qs, xs, tau, got), ns * (dist_ops(m, n, s) + 2.0 * m * n))
    out["sc_score"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: score_ops.sc_scores_fused(qs, xs, tau), 10),
        plain_ms=time_ms(lambda: sc_score_ref(qs, xs, tau), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(ns=ns, m=m, n=n, s=s, collision_count=count,
                    mean_score=float(got.float().mean())),
    )
    return out


def profile_batch(fn) -> dict:
    """One call of ``fn`` (a served batch) under ``torch.profiler``: wall
    time, the device's busy time (the device events' own time summed;
    operator events, whose device time repeats their kernels', are left out)
    and idle share, and the kernels taking the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # the same batch once untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_ = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_us = sum(t for _, t, _ in kernels_)
    top = sorted(kernels_, key=lambda r: -r[1])[:8]
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / wall_us if busy_us else None,
        top=[dict(name=name[:60], ms=t / 1e3, calls=c) for name, t, c in top],
    )


def same_answers(card, cpu, rtol=2e-5) -> dict:
    """Card vs CPU answers: distances at each rank within ``rtol``, ids
    equal except where distances tie within ``rtol``, scores of the ids
    both return exactly equal."""
    ci, cd, cs = (t.cpu().numpy() for t in card)
    pi, pd, ps = (t.numpy() for t in cpu)
    import numpy as np

    if not np.allclose(cd, pd, rtol=rtol, atol=0):
        raise AssertionError("card and CPU distances differ beyond rtol")
    swaps = 0
    for r in range(ci.shape[0]):
        for c in np.flatnonzero(ci[r] != pi[r]):
            tied = np.abs(pd[r] - pd[r, c]) <= rtol * pd[r, c]
            if tied.sum() < 2 and not np.isclose(cd[r, c], pd[r, c], rtol=rtol):
                raise AssertionError(f"card and CPU ids differ without a tie at ({r}, {c})")
            swaps += 1
        p_scores = dict(zip(pi[r].tolist(), ps[r].tolist()))
        for i, s in zip(ci[r].tolist(), cs[r].tolist()):
            if i in p_scores and p_scores[i] != s:
                raise AssertionError(f"card and CPU scores differ for id {i}")
    return dict(ids_equal=int((ci == pi).sum()), ids_total=int(ci.size), tie_swaps=swaps)


def serve_times(fn, reps: int = 5) -> tuple[list[float], object]:
    """Host-clock latencies (ms) of ``reps`` calls of ``fn``, each ending in
    a synchronise, and the last call's result."""
    import torch

    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat, res


def query_modes_phase(data, index, q64, answers: dict, k: int) -> dict:
    """The dense and streaming modes (``block_n`` = 4096) through engines
    over the main path's index, batches of 1, 8 and 64, each answer held
    against the fused answer ``answers[m]``; then one streaming batch under
    the profiler.  Returns the path's launches (both modes)."""
    import numpy as np
    import torch

    from repro_torch import EnginePolicy, SuCoEngine, kernels, suco_query

    modes, total = {}, None
    for mode in ("dense", "streaming"):
        eng = SuCoEngine(data, index, EnginePolicy(alpha=0.05, beta=0.02, mode=mode,
                                                   block_n=4096), device=data.device)
        eng.query(q64[:1], k)  # first use: allocator and sort workspaces
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rows = {}
        for m in (1, 8, 64):
            syncs0 = eng.stats().host_syncs
            lat, res = serve_times(lambda m=m: eng.query(q64[:m], k))
            rows[m] = dict(latency_ms=lat, median_ms=float(np.median(lat)),
                           host_syncs_per_batch=(eng.stats().host_syncs - syncs0) / len(lat),
                           bitwise_equal_fused=all(torch.equal(a, b)
                                                   for a, b in zip(res, answers[m])),
                           **same_answers(res, [t.cpu() for t in answers[m]]))
            if rows[m]["host_syncs_per_batch"] != 0:
                raise AssertionError(f"the {mode} mode synchronised with the host")
        counts = kernels.launch_counts()
        total = counts if total is None else {n_: total[n_] + c for n_, c in counts.items()}
        # torch's own record of synchronising calls, over one more batch
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            eng.query(q64, k)
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        modes[mode] = dict(serve=rows, launches=counts, sync_debug_warnings=len(syncs),
                           sync_debug_sites=sorted({f"{Path(w.filename).name}:{w.lineno}"
                                                    for w in syncs}))
    n = data.shape[0]
    emit(dict(phase="query_modes", block_n=4096, chunks=-(-n // 4096), **modes))
    check_launched("query_modes", total)
    emit(dict(phase="profile_streaming", **{"64": profile_batch(
        lambda: suco_query(data, index, q64, k=k, alpha=0.05, beta=0.02, mode="streaming",
                           block_n=4096))}))
    return total


def sc_linear_phase(data, x_np, q_np, q64, gt, ns: int, k: int) -> dict:
    """SC-Linear at ``Ns`` contiguous subspaces, alpha = 0.05, beta = 0.02,
    batches of 8 and 64 (recall@10 against ``gt``, peak memory, launches
    per batch); the SC-scores of 8 queries again on the CPU, which must be
    equal; then one batch under the profiler.  Returns the path's
    launches."""
    import numpy as np
    import torch

    from repro_torch import kernels, sc_linear_query
    from repro_torch.core import subspace as sub
    from repro_torch.core.sc_linear import sc_scores_from_subspaces
    from repro_torch.data import recall

    n, d = data.shape
    spec = sub.contiguous_spec(d, ns)
    kw = dict(spec=spec, k=k, alpha=0.05, beta=0.02)
    sc_linear_query(data, q64[:8], **kw)  # first use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    serve, results = {}, {}
    for m in (8, 64):
        lat, results[m] = serve_times(lambda m=m: sc_linear_query(data, q64[:m], **kw))
        serve[m] = dict(latency_ms=lat, median_ms=float(np.median(lat)),
                        recall_at_10=recall(results[m].ids.cpu().numpy(), gt[:m]))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launched("sc_linear", launches)
    batches = 2 * len(lat)
    per_batch = {name: c / batches for name, c in launches.items() if c}
    if per_batch.get("pairwise_sqdist") != ns or per_batch.get("sc_score") != 1:
        raise AssertionError(f"SC-Linear launches per batch: {per_batch}")

    # the CPU re-check: the same fixed-order distances give the same SC-scores
    t0 = time.perf_counter()
    x_c, q_c = torch.from_numpy(x_np), torch.from_numpy(q_np[:8])
    cpu_res = sc_linear_query(x_c, q_c, **kw)
    count = sub.collision_count(n, 0.05)
    card_scores = sc_scores_from_subspaces(sub.split_padded(spec, data),
                                           sub.split_padded(spec, q64[:8]), count)
    cpu_scores = sc_scores_from_subspaces(sub.split_padded(spec, x_c),
                                          sub.split_padded(spec, q_c), count)
    scores_equal = torch.equal(card_scores.cpu(), cpu_scores)
    recheck = dict(seconds=time.perf_counter() - t0, scores_equal=scores_equal,
                   **same_answers(results[8], cpu_res))
    emit(dict(phase="sc_linear", ns=ns, alpha=0.05, beta=0.02, serve=serve, launches=launches,
              launches_per_batch=per_batch, max_memory_allocated=peak, cpu_recheck=recheck))
    if not scores_equal:
        raise AssertionError("SC-Linear's SC-scores differ between the card and the CPU")
    for m, row in serve.items():
        if row["recall_at_10"] < 0.95:
            raise AssertionError(f"SC-Linear recall@10 {row['recall_at_10']} below 0.95 at m={m}")
    del results, card_scores
    emit(dict(phase="profile_sc_linear", **{"64": profile_batch(
        lambda: sc_linear_query(data, q64, **kw))}))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and queries")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA card")
    import numpy as np

    from repro_torch import EnginePolicy, SuCoConfig, SuCoEngine, kernels
    from repro_torch.core import subspace as sub
    from repro_torch.core.kmeans import init_random
    from repro_torch.data import gaussian_mixture, make_queries, recall
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit(dict(phase="device", name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda))

    # 2. build every kernel from the checkout's sources, one nvcc each, at once
    t0 = time.perf_counter()
    built = _build.build_all()
    emit(dict(phase="build", built=built, seconds=time.perf_counter() - t0,
              ptxas={n: _build.ptxas_report(n) for n in _build.SOURCES}))

    # data at SIFT1M's shape (ann-benchmarks sift-128-euclidean)
    n, d, k = 1_000_000, 128, 10
    t0 = time.perf_counter()
    x_np = gaussian_mixture(n, d, args.seed)
    q_np = make_queries(x_np, 64, seed=args.seed + 1)
    data = torch.from_numpy(x_np).to(dev)
    q64 = torch.from_numpy(q_np).to(dev)
    cfg = SuCoConfig()
    policy = EnginePolicy(alpha=0.05, beta=0.02)
    emit(dict(phase="data", n=n, d=d, queries=64, seed=args.seed,
              seconds=time.perf_counter() - t0, config=cfg.__dict__,
              alpha=policy.alpha, beta=policy.beta))

    # 3. main path: build, warm up, serve 1 / 8 / 64 queries
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine = SuCoEngine.build(data, cfg, policy=policy, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = kernels.launch_counts()
    t0 = time.perf_counter()
    engine.warmup(batch_sizes=(1, 8, 64), ks=(k,))
    warm_s = time.perf_counter() - t0
    serve = {}
    answers = {}
    for m in (1, 8, 64):
        syncs0 = engine.stats().host_syncs
        lat, answers[m] = serve_times(lambda m=m: engine.query(q64[:m], k))
        serve[m] = dict(latency_ms=lat, median_ms=float(np.median(lat)),
                        host_syncs_per_batch=(engine.stats().host_syncs - syncs0) / len(lat),
                        tiles=engine.tiles_for(m, k).__dict__)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # recall@10 against an exact k-NN taken on the card in fp64 (a yardstick only)
    xd = data.double()
    dist = (q64.double() ** 2).sum(1)[:, None] + (xd**2).sum(1)[None, :] - 2 * q64.double() @ xd.T
    gt = torch.sort(dist, dim=1, stable=True).indices[:, :k].cpu().numpy()
    del xd, dist
    rec = recall(answers[64].ids.cpu().numpy(), gt)
    emit(dict(phase="main_path", build_seconds=build_s, build_launches=build_launches,
              warmup_seconds=warm_s, serve=serve, launches=launches,
              max_memory_allocated=peak, recall_at_10=rec,
              stats=engine.stats()._asdict()))
    if rec < 0.95:
        raise AssertionError(f"recall@10 {rec} below the 0.95 floor")
    check_launched("main_path", launches)

    # where a served batch's time goes: device busy share and the top kernels
    emit(dict(phase="profile", **{str(m): profile_batch(lambda m=m: engine.query(q64[:m], k))
                                  for m in (1, 64)}))

    # 4. the dense and streaming query modes over the same index
    launches_by_path = dict(main_path=launches)
    launches_by_path["query_modes"] = query_modes_phase(data, engine.index, q64, answers, k)

    # 5. SC-Linear (Algorithm 1) over the same data
    launches_by_path["sc_linear"] = sc_linear_phase(data, x_np, q_np, q64, gt, cfg.n_subspaces, k)

    # 6. each kernel against its plain version at its path's shapes
    spec = engine.index.spec
    h1, h2 = sub.split_halves_padded(spec, sub.permute(spec, data))
    both = torch.cat([h1, h2]).contiguous()
    del h1, h2
    c0 = init_random(both, cfg.sqrt_k, torch.Generator().manual_seed(cfg.seed))
    checks = check_kernels(dev, data, both, c0, engine.index, q64, cfg, engine.tiles_for(64, k))
    del both
    checks.update(check_query_kernels(dev, data, engine.index, q64, cfg, engine.tiles_for(64, k)))
    emit(dict(phase="kernel_checks", **{name: rec for name, rec in checks.items()}))

    # 7. the same 8 queries on the CPU: plain versions over the same index
    t0 = time.perf_counter()
    cpu_policy = EnginePolicy(alpha=0.05, beta=0.02, tiles=engine.tiles_for(8, k))
    cpu_engine = SuCoEngine(x_np, engine.index.to("cpu"), cpu_policy, device="cpu")
    cpu_res = cpu_engine.query(torch.from_numpy(q_np[:8]), k)
    card_res = engine.query(q64[:8], k)
    emit(dict(phase="cpu_recheck", seconds=time.perf_counter() - t0,
              **same_answers(card_res, cpu_res)))

    rows = []
    for name, (src, replaces) in SOURCES.items():
        rec_ = checks[name]
        path = PATH_OF.get(name)
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches_by_path[path][name] if path else 0,
                         path=path,
                         launches_by_path={p_: c[name] for p_, c in launches_by_path.items()},
                         max_abs_err=rec_["max_abs_err"],
                         ms=rec_["ms"], plain_ms=rec_["plain_ms"], bound_ms=rec_["bound_ms"],
                         bound_by=rec_["bound_by"], library_ms=rec_["library_ms"]))
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
