#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (``--seed S`` picks
the data).  It builds the CUDA kernels from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version at the shapes of the main path,
then builds a SuCo index over SIFT1M's shape (n = 1,000,000, d = 128, data
from ``gaussian_mixture``) with the default ``SuCoConfig`` and serves batches
of 1, 8 and 64 queries through ``SuCoEngine``, counting each kernel's
launches.  It checks recall@10 against an exact k-NN, and answers 8 queries
again on the CPU with the plain versions over the same index.

Output: one JSON line per phase; then a ``{"kernels": [...]}`` line (per
kernel: its launches on the main path, its error against the plain version,
its time, the plain version's time, the card's bound for the same work, and a
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
}


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


def profile_batch(engine, q, k: int) -> dict:
    """One served batch under ``torch.profiler``: wall time, the device's
    busy time (the device events' own time summed; operator events, whose
    device time repeats their kernels', are left out) and idle share, and
    the kernels taking the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.query(q, k)  # the same batch once untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.query(q, k)
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
        lat = []
        syncs0 = engine.stats().host_syncs
        for _ in range(5):
            t0 = time.perf_counter()
            res = engine.query(q64[:m], k)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        answers[m] = res
        serve[m] = dict(latency_ms=lat, median_ms=float(np.median(lat)),
                        host_syncs_per_batch=(engine.stats().host_syncs - syncs0) / 5,
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
    missing = [name for name, c in launches.items() if c < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # where a served batch's time goes: device busy share and the top kernels
    emit(dict(phase="profile", **{str(m): profile_batch(engine, q64[:m], k) for m in (1, 64)}))

    # 4. each kernel against its plain version at the main path's shapes
    spec = engine.index.spec
    h1, h2 = sub.split_halves_padded(spec, sub.permute(spec, data))
    both = torch.cat([h1, h2]).contiguous()
    del h1, h2
    c0 = init_random(both, cfg.sqrt_k, torch.Generator().manual_seed(cfg.seed))
    checks = check_kernels(dev, data, both, c0, engine.index, q64, cfg, engine.tiles_for(64, k))
    del both
    emit(dict(phase="kernel_checks", **{name: rec for name, rec in checks.items()}))

    # 5. the same 8 queries on the CPU: plain versions over the same index
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
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches[name], max_abs_err=rec_["max_abs_err"],
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
