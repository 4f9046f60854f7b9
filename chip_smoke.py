#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (``--seed S`` picks
the data).  It builds the CUDA kernels from ``src/repro_torch/csrc``, then
drives twelve paths, each with every kernel's launch count set to 0 just
before it and read just after.  Seven run over SIFT1M's shape (n =
1,000,000, d = 128, data from ``gaussian_mixture``):

* ``main_path``: build a SuCo index with the default ``SuCoConfig`` and serve
  batches of 1, 8 and 64 queries through ``SuCoEngine`` (fused mode);
* ``query_modes``: the same batches through ``suco_query``'s dense and
  streaming modes (engines over the same index), each answer held against
  the fused one;
* ``sc_linear``: SC-Linear (Algorithm 1, ``sc_linear_query``) at Ns = 8 on
  batches of 8 and 64;
* ``kmeans_library``: the K-means library at its users' shapes: PQ8x8
  codebook training (``kmeans_batched`` on the (8, 1M, 16) sub-vectors,
  k = 256, 20 chunked Lloyd steps, unpaired), IVF1024 coarse assignment at
  full width (``init_centroids_pp`` of 1,024 centroids from 32,768 rows,
  then ``assign`` of all 1M rows) and IVF1024 Lloyd training at d = 128
  (``kmeans`` of a 262,144-row sample from those seeds, 20 chunked steps);
* ``lifecycle``: a minibatch build at 1M and the fused engine over it; the
  main path's index in a mutable engine (``capacity`` 1.1M): 25 inserts of
  4,000 points, one delete of 50,000 ids, batches of 1, 8 and 64 in the
  fused and dense modes before and after, with checks (a)-(f) of the
  answers, the counts and the warm state; then ``SuCoIndex.save`` / ``load``
  on the card;
* ``ann_serve``: the ANN serving layer (``repro_torch.serve``) over the main
  path's engine: a 2-level ``DegradationLadder`` warmed for batches of 1-16
  at k = 5 and 10; the JAX package's traffic mixes ``steady_b8``,
  ``mixed_batch`` and ``mixed_batch_k`` (``benchmarks/serve.py``: one step
  after each burst) through ``AnnServer`` and ``AsyncAnnServer(depth=2)``,
  their answers equal request by request; a forced 0, 1, 2, 1, 0 ladder
  cycle over the 64 queries, each level's success rate (the exact nearest
  neighbour in the top 10) at least its Theorem-2 ``quality_bound`` and rows
  1 and 2 launched at each; 192 requests at once under an
  ``OverloadController``; ``engine.autoscaled()`` warmed on the observed
  sizes and replaying ``mixed_batch``; one sync step and one async window
  under the profiler.  No (bucket, k) pair and no kernel library may be
  added after the warm-up.
* ``mutable_serve``: the durable mutable serving stack
  (``repro_torch.serve.mutation`` / ``durability`` / ``chaos``) over the main
  path's index: a 1.2M-capacity engine under a 2-level ladder,
  ``AnnServer``, ``MutationManager`` and a group-commit ``Durability`` root;
  25 inserts of 4,000 and a delete of 50,000 keys between ``steady_b8``
  bursts (no answer may hold a deleted key; the drift monitor must name
  the fill); ``reindex_async`` prepared on the manager's stream while this
  thread serves bursts (one profiled: busy share per stream), committed
  with its snapshot, and a second successor built from the same gather on
  the serving stream, bit for bit equal (fingerprint and 64 answers); two
  more inserts, a kill and ``recover`` on the card, bit for bit; then
  ``recovery_drill`` at every crash point under both fsync policies at
  n = 65,536.  No (bucket, k) pair and no library after the commit.

The eighth, ``lm_serve``, serves RWKV6-1.6B (``get_config("rwkv6-1.6b")``, 24
layers, d_model 2,048, vocab 65,536, bf16 compute, fp32 master weights drawn
on the card from the seed) through ``repro_torch.launch.serve.Server``: 16
requests of 2,048-token prompts, 8 slots, 32 greedy tokens each.
``lm_cpu_recheck`` then runs a 2-layer model of the same width on the card
and, with the same weights and the card's tokens, on the CPU.

The ninth, ``lm_serve_hybrid``, runs after the kernel checks and the CPU
re-check below and serves Zamba2-1.2B (``get_config("zamba2-1.2b")``
unchanged: 38 Mamba2 layers, d_model 2,048, 32 heads, inner width 4,096,
state 64, conv 4, and one shared dense block, 32 heads of 64 with SwiGLU
d_ff 8,192, applied after every 6th layer; vocab 32,000) with the same
traffic, the fp32 master dropped once the server holds its compute tree;
each prefill batch must launch row 11 (in SSD mode) once a Mamba2 layer, 38
times, and no other port kernel.  ``lm_cpu_recheck_hybrid`` then runs 3
layers of that width at period 2 (one unit and a tail layer, so the shared
block and its KV cache run; a 64-token prompt, 8 tokens) on the card and
on the CPU, held as ``lm_cpu_recheck``.

The tenth, ``lm_serve_moe``, runs after ``lm_cpu_recheck_hybrid`` and serves
OLMoE-1B-7B (``get_config("olmoe-1b-7b")`` unchanged: 16 layers, d_model
2,048, 16 heads of 128, 64 experts of SwiGLU d_ff 1,024, top-8, capacity
factor 1.25, vocab 50,304) with the same traffic, the fp32 master dropped
once the server holds its bf16 compute tree; the path must launch no port
kernel, one prefill batch run twice must give equal logits bit for bit, and
layer 0's stages (routing, dispatch, the buffer's gather, the experts, the
combine) are timed alone at the prefill and decode shapes.
``lm_serve_mixtral`` serves Mixtral-8x7B the same way at full width (d_model
4,096, 32 / 8 heads of 128, 8 experts of d_ff 14,336, top-2, window 4,096)
with 6 of its 32 layers (``MIXTRAL_LAYERS``: all 32 hold 93.4 GB in bf16);
its output says ``layers`` and ``layers_full``.  ``lm_cpu_recheck_moe`` (2
OLMoE layers; a 64-token prompt gives a capacity of 10 against 8 pairs an
expert on average, so pairs drop) and ``lm_cpu_recheck_mixtral`` (2 Mixtral
layers at ``sliding_window`` 32, as ``reduced_config`` sets it, so the
window masks at the 64-token prompt) then run on the card and on the CPU,
held as ``lm_cpu_recheck``.

The eleventh, ``lm_serve_dense``, runs last, after the kernel checks and the
CPU re-check below (the profiler loses kernels far more often in traces
taken after it), and serves Gemma2-9B (``get_config("gemma2-9b")``
unchanged: 42 layers, d_model 3,584, 16 query and 8 KV heads of 256, d_ff
14,336, vocab 256,000, local / global windows, softcaps, GeGLU, sandwich
norms, tied embeddings) the same way and with the same traffic, the fp32
master dropped once the server holds its bf16 compute tree; the path is
PyTorch ops only and must launch no port kernel.  ``lm_cpu_recheck_dense``
then runs a 2-layer Gemma2 of that width (``local_window`` 32, as
``reduced_config`` sets it: layer 0 local, layer 1 global; a 64-token
prompt, 8 tokens) on the card and on the CPU, held as ``lm_cpu_recheck``.

It checks recall@10 against an exact k-NN, answers 8 queries of the fused
(before and after mutation) and SC-Linear paths again on the CPU with the
plain versions, and holds each kernel against its plain PyTorch version at
the shapes of its path.  Row 1 (the fused query's chunk kernel) is held on
the arguments the fused batches of 1, 8 and 64 queries gave it (each
batch's first chunk, thr = -1 and its slots overflowing, and its second,
with and without a tombstone mask, two launches to equal bits) and timed
over each batch's chunks in turn; rows 1 and 7 also at an index width whose
one-query bitmap is past shared memory (Ns = 16, sqrt_k = 341: the L2
route).  The screened assignment (rows 6 and 5-wide) is also
held to its plain version on adversarial inputs, and at the IVF shapes its
re-checks per point and its largest screen error over its margin (<= 0.25)
are reported, and its best distances (row 3's wide variant reads them) must
equal the plain minimum distance bit for bit.  Row 4's narrow kernel (an
FFMA screen with an exact re-check) reports at the build's shape its
re-checked (point, half)s per point and its largest screen error over its
margin (<= 0.25), and its outputs must keep the fingerprint they had before
its redesign; its wide route is held at (2, 262,144, 128), k = 256.  Row
5's narrow kernel (a 3xTF32 screen with the codebook resident) reports at
PQ8x8's shape its re-checks per point and its largest screen error over its
margin (<= 0.25), and its best distances must equal the plain minimum; rows
3-6, every variant the ops take, are held to their plain versions on NaN
and inf data (torch.argmin's index, the first NaN distance).  Row 3 (the
Lloyd statistics) is held at all three of its shapes (the build's, PQ8x8's
and IVF1024's), and two launches must give equal bits at each.  Row 11 (linear attention) is
also held with every decay at the clip (1e-6) and with half of them at 1,
at chunks 64 and 128, both shifts, and two launches at the RWKV6 prefill
shape must give equal bits.  Row 9 (SC-Linear's SC-score kernel: a 3xTF32
screen with an exact re-check near each threshold) is held at SC-Linear's
shape, its thresholds from row 10's distances, to its plain version and to
the collisions of those distances, on two launches, and at m = 1, 8 and 64
on both its copy widths; its probe reports the re-checks per (pair,
subspace) and its largest screen error over its margin (<= 0.25).  Row
10's output there must keep the fingerprint it had before row 9's redesign.

Output: one JSON line per phase; then a ``{"kernels": [...]}`` line (per
kernel: its launches on its path, its error against the plain version, its
time, the plain version's time, the card's bound for the same work, and a
library call's time where one PyTorch call computes the same function); then
``nvidia-smi``'s name and power limit; last, ``{"ok": true, "device": ...}``.
Row 11's entry also carries an ``ssd`` variant, its
check at Zamba2's SSD shape.  Any failure raises, exits non-zero and prints
no last line.  Without a CUDA
card, or outside a checkout of the repository, it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA cores, fp32 (also taken for 32-bit int ops)
TF32_OPS_PER_S = 495e12  # H100 SXM tensor cores, dense TF32
#: H100 SXM special-function units: 16 exponentials (or logarithms) a clock
#: per SM, 132 SMs at the 1.98 GHz boost clock the fp32 rate assumes
SFU_OPS_PER_S = 16 * 132 * 1.98e9
FENCE = 4  # uncounted spin kernels at each end of a device_ms trace
#: row 10's output at SC-Linear's first subspace (m = 64, n = 1M, s = 16) from
#: the SIMT kernel that row 10's register design replaced, by ``--seed`` (its
#: ``time_sc_linear.py`` run): the redesign keeps its bits
PARENT_PAIRWISE_FINGERPRINT = {0: -4702138040020805353}
#: row 4's outputs (assign, cell_counts) at the build's shape (the main path's
#: half-subspaces against its index's centroids) from the SIMT kernel that the
#: FFMA screen replaced, by ``--seed`` (``tools/time_assign.py``'s
#: ``pair_build`` on that tree): the redesign keeps its bits
PARENT_PAIR_FINGERPRINT = {0: [1565341636113, 28001088876]}
RETAKES = 10  # device_ms traces taken again, at most, for kernels the tracer lost
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
        "src/repro_torch/csrc/sc_score_fused.cu", "src/repro/kernels/sc_score/kernel.py:303"),
    "pairwise_sqdist": (
        "src/repro_torch/csrc/pairwise_l2.cu", "src/repro/kernels/pairwise_l2/kernel.py:49"),
    "kmeans_assign_batched": (
        "src/repro_torch/csrc/kmeans_assign.cu", "src/repro/kernels/kmeans_assign/kernel.py:93"),
    "kmeans_assign": (
        "src/repro_torch/csrc/kmeans_assign.cu", "src/repro/kernels/kmeans_assign/kernel.py:52"),
    "linear_attn": (
        "src/repro_torch/csrc/linear_attn.cu", "src/repro/kernels/linear_attn/kernel.py:95"),
}
#: the path whose launches each kernel reports (the prefilter kernel is on no
#: path: only its public op and the kernel checks call it)
PATH_OF = {
    "sc_score_cells_prefilter_compact": "main_path", "gather_rerank": "main_path",
    "kmeans_stats": "main_path", "kmeans_pair_assign_hist": "main_path",
    "sc_score_cells": "query_modes", "sc_score": "sc_linear", "pairwise_sqdist": "sc_linear",
    "kmeans_assign_batched": "kmeans_library", "kmeans_assign": "kmeans_library",
    "linear_attn": "lm_serve",
}
#: the kernels the lifecycle path runs (each reports its launches on its
#: first path above): Lloyd statistics for the minibatch build and every
#: insert, the compact and gather kernels for fused queries, the chunk
#: scores for dense ones
LIFECYCLE_KERNELS = ("kmeans_stats", "sc_score_cells_prefilter_compact", "gather_rerank",
                     "sc_score_cells")
#: the kernels the ANN serving path runs: every ladder level answers through
#: the fused query (each reports its launches on the main path above)
ANN_SERVE_KERNELS = ("sc_score_cells_prefilter_compact", "gather_rerank")
#: the JAX package's serving traffic mixes (``benchmarks/serve.py``): bursts
#: of single-query requests, the burst sizes the admission queue sees
#: between steps and the per-request k mix
SERVE_MIXES = (
    dict(name="steady_b8", sizes=(8,), ks=(10,), bursts=24),
    dict(name="mixed_batch", sizes=(1, 2, 5, 8, 16), ks=(10,), bursts=20),
    dict(name="mixed_batch_k", sizes=(1, 4, 16), ks=(5, 10), bursts=20),
)
SERVE_MAX_BATCH, SERVE_OVERLOAD_REQUESTS = 16, 192
#: Mixtral-8x7B's layers served: each holds 1.41 B parameters, 5.6 GB as the
#: fp32 master and 2.8 GB in bf16 while both live at init; all 32 need 93.4 GB
#: in bf16 alone, more than the card
MIXTRAL_LAYERS = 6
#: the library call each kernel is timed beside, where one PyTorch call
#: computes the same function (TF32 off)
LIBRARY = {
    "pairwise_sqdist": "torch.cdist(use_mm_for_euclid_dist) ** 2",
    "kmeans_assign_batched": "torch.cdist(use_mm_for_euclid_dist).argmin(-1), batched",
    "kmeans_assign": "torch.cdist(use_mm_for_euclid_dist).argmin(-1)",
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


def device_ms(fn, reps: int, n: int = 5, warmup: int = 2) -> dict:
    """The device's own time for one call of ``fn``: the kernels' time under
    ``torch.profiler`` over at least 10 calls, per call; the median of ``n``
    such readings, every reading, the device events a call launches, the
    events the tracer lost and the traces taken again.  For a short kernel
    this differs from :func:`time_ms`, whose events over back-to-back calls
    read how fast the host issues them.

    The tracer can lose kernels: a few of a trace, mostly its first or
    last, and now and then all of them.  So each trace opens and closes
    with ``FENCE`` spin kernels that are not counted; each kernel name
    counts at its mean time for the launches a call that its count rounds
    to; and a trace that shows fewer launches a call than the most any
    trace showed is taken again (``RETAKES`` times at most) before it
    falls back to CUDA events around ``reps`` back-to-back calls
    (:func:`time_ms`), with ``clock`` saying which clock read the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = max(reps, 10)

    def fence():
        for _ in range(FENCE):
            torch.cuda._sleep(1000)

    def trace() -> list[tuple[float, int, int]]:
        """(mean us, count, launches a call) of each kernel name."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fence()
            for _ in range(reps):
                fn()
            fence()
            torch.cuda.synchronize()
        return [(e.self_device_time_total / e.count, e.count, round(e.count / reps))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]

    for _ in range(warmup):
        fn()
    traces, retakes = [trace() for _ in range(n)], 0
    most = max(sum(k for _, _, k in t) for t in traces)
    for i in range(n):
        while sum(k for _, _, k in traces[i]) < most:
            if retakes == RETAKES or most < 1:
                warnings.warn(f"device_ms: a trace kept missing kernels ({most} a call); "
                              "timed by CUDA events instead")
                return dict(ms=time_ms(fn, reps), readings=[], events_per_call=most,
                            events_lost=None, retakes=retakes, clock="cuda_events")
            traces[i], retakes = trace(), retakes + 1
    readings = [sum(mean * k for mean, _, k in t) / 1e3 for t in traces]
    lost = sum(k * reps - count for t in traces for _, count, k in t)
    return dict(ms=statistics.median(readings), readings=readings, events_per_call=most,
                events_lost=lost, retakes=retakes, clock="profiler")


def timed(fn, reps: int) -> dict:
    """A kernel row's times: ``ms`` on the device clock (:func:`device_ms`),
    ``call_ms`` by CUDA events over ``reps`` back-to-back calls
    (:func:`time_ms`), and the device readings."""
    dev = device_ms(fn, reps)
    return dict(ms=dev["ms"], call_ms=time_ms(fn, reps), ms_readings=dev["readings"],
                ms_clock=dev["clock"], device_events_per_call=dev["events_per_call"],
                device_events_lost=dev["events_lost"], device_retakes=dev["retakes"])


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate, in ms."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def fingerprint(t) -> int:
    """A position-weighted sum of an integer tensor's entries (a float
    tensor's bits, as int32): two trees whose outputs share it give the same
    bits, barring a collision."""
    import torch

    if t.is_floating_point():
        t = t.view(torch.int32)
    flat = t.flatten().long()
    return int((flat * (torch.arange(flat.numel(), device=t.device) % 7919 + 1)).sum())


# the K-means library's users: PQ8x8 codebooks (k = 256, chunks of 4,096) and
# IVF1024 (faiss trains it on 256 points a list; chunks of 2,048 points give
# the one-codebook statistics kernel 128 blocks), 20 Lloyd steps each
PQ_M, PQ_K, IVF_K, LLOYD_ITERS, PQ_BLOCK_N, IVF_BLOCK_N = 8, 256, 1024, 20, 4096, 2048


def build_stats_inputs(data, spec, cfg):
    """Row 3's inputs on the main path: the build's 2 Ns half-subspaces of the
    data, ``(2Ns, n, s)``, and the build's seeded start, ``(2Ns, sqrt_k, s)``."""
    import torch

    from repro_torch.core import subspace as sub
    from repro_torch.core.kmeans import init_random

    h1, h2 = sub.split_halves_padded(spec, sub.permute(spec, data))
    both = torch.cat([h1, h2]).contiguous()
    del h1, h2
    return both, init_random(both, cfg.sqrt_k, torch.Generator().manual_seed(cfg.seed))


def pq_inputs(data, seed: int):
    """PQ8x8's ``(8, n, d / 8)`` sub-vectors and its seeded random start."""
    import torch

    from repro_torch.core.kmeans import init_random

    n, d = data.shape
    xs = data.reshape(n, PQ_M, d // PQ_M).transpose(0, 1).contiguous()
    return xs, init_random(xs, PQ_K, torch.Generator().manual_seed(seed))


def ivf_sample(data, seed: int):
    """IVF1024's training sample: 256 rows a list, at most half the data."""
    import torch

    n = data.shape[0]
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(seed + 4))
    return data[pick[:min(256 * IVF_K, n // 2)].to(data.device)].contiguous()


def ivf_seeds(data, seed: int):
    """IVF1024's kmeans++ start: 1,024 centroids seeded from 32,768 rows."""
    import torch

    from repro_torch.core.kmeans import init_centroids_pp

    return init_centroids_pp(data, IVF_K, sample_n=32 * IVF_K,
                             generator=torch.Generator().manual_seed(seed + 1))


def cell_score_inputs(index, q):
    """The query state rows 1, 7 and 8 read: each query's cell ranks and
    activation cutoffs at alpha = 0.05, ``(ranks (Ns, m, K), cuts (Ns, m))``."""
    from repro_torch.core import subspace as sub
    from repro_torch.core.suco import suco_cell_ranks

    return suco_cell_ranks(index, q, sub.collision_count(index.cell_ids.shape[1], 0.05))


def fused_compact_calls(engine, q, k: int) -> list[dict]:
    """The arguments row 1 (``sc_scores_cells_prefilter_compact``) takes on
    each chunk of one fused batch, in order: ``engine.query(q, k)`` served
    once with the op wrapped to record them (``thr`` is -1 on the first
    chunk, then the warm pool's minimum)."""
    from repro_torch.core import suco

    op, calls = suco.sc_scores_cells_prefilter_compact, []

    def record(ranks, cuts, cells, thr, limit, keep_cols=None, *, cap):
        calls.append(dict(ranks=ranks, cuts=cuts, cells=cells, thr=thr.clone(), limit=limit,
                          keep_cols=keep_cols, cap=cap))
        return op(ranks, cuts, cells, thr, limit, keep_cols, cap=cap)

    suco.sc_scores_cells_prefilter_compact = record
    try:
        engine.query(q, k)
    finally:
        suco.sc_scores_cells_prefilter_compact = op
    return calls


def replay_compact(chunks: list[dict]) -> list:
    """Row 1 over recorded chunks (:func:`fused_compact_calls`), in order:
    each chunk's ``(scores, surv_cols, surv_scores, count)``."""
    from repro_torch.kernels.sc_score import ops

    return [ops.sc_scores_cells_prefilter_compact(
        c["ranks"], c["cuts"], c["cells"], c["thr"], c["limit"], c["keep_cols"], cap=c["cap"])
        for c in chunks]


def sweep_plan(index, m: int, bc: int, ns: int | None = None, k_cells: int | None = None) -> dict:
    """The chunk-score sweep a launch over ``bc`` columns for ``m`` queries
    takes on this card (``kernel.plan``): Q, the column tile, the tiles,
    the bitmap's route (``bitmap_route``) and the shared memory a block
    uses; at the index's width unless ``ns`` and ``k_cells`` are given."""
    import torch

    from repro_torch.kernels.sc_score import kernel as score_kernel

    ns = index.cell_ids.shape[0] if ns is None else ns
    k_cells = index.n_cells if k_cells is None else k_cells
    one = score_kernel.smem_bytes(ns, k_cells, 1)
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    p = score_kernel.plan(one, m, bc, props.shared_memory_per_block_optin,
                          props.multi_processor_count)
    return dict(q=p.q, tile=p.tile, tiles=p.tiles, bitmap_route="l2" if p.l2 else "shared",
                smem_bytes=0 if p.l2 else p.q * one)


def l2_route_inputs(dev, ns: int, sqrt_k: int, m: int, bc: int):
    """Chunk-score inputs at an index width whose one-query bitmap is past a
    block's shared memory (Ns = 16 at sqrt_k = 341: 232,576 bytes): random
    ranks, cuts, cell ids (a column slice) and warm-pool thresholds, from a
    fixed seed."""
    import torch

    g = torch.Generator(dev).manual_seed(ns * sqrt_k + m)
    k_cells = sqrt_k**2
    ranks = torch.randint(0, k_cells, (ns, m, k_cells), generator=g, device=dev,
                          dtype=torch.int32)
    cuts = torch.randint(-1, k_cells // 8, (ns, m), generator=g, device=dev, dtype=torch.int32)
    cells = torch.randint(0, k_cells, (ns, bc + 40), generator=g, device=dev,
                          dtype=torch.int32)[:, 13:13 + bc]
    thr = torch.randint(1, ns // 2 + 1, (m,), generator=g, device=dev, dtype=torch.int32)
    return ranks, cuts, cells, thr


def check_kernels(dev, data, both, c0, engine, q64, cfg, top_k: int, seed: int) -> dict:
    """Each kernel against its plain version on the same inputs, at the main
    path's shapes.  Integers must be equal; floats within the stated
    tolerance.  Returns per-kernel records for the ``kernels`` line."""
    import torch

    from repro_torch.kernels.gather_rerank import ops as gather_ops
    from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.kmeans_assign.ref import (
        kmeans_pair_assign_hist_ref,
        kmeans_stats_ref,
    )
    from repro_torch.kernels.sc_score import ops as score_ops
    from repro_torch.kernels.sc_score.ref import sc_score_cells_prefilter_compact_ref

    out = {}
    index, tiles = engine.index, engine.tiles_for(64, top_k)
    fused = {m_: fused_compact_calls(engine, q64[:m_], top_k) for m_ in (1, 8, 64)}
    b, n, s = both.shape
    k = cfg.sqrt_k
    bn = cfg.block_n

    # kmeans_stats: one Lloyd pass over the 2*Ns codebooks from the seeds
    got = kmeans_ops.kmeans_stats(both, c0, block_n=bn, with_assign=True)
    want = kmeans_stats_ref(both, c0, block_n=bn)
    err_sums = stats_errors("kmeans_stats", both, got, want)
    same_bits("kmeans_stats", got, kmeans_ops.kmeans_stats(both, c0, block_n=bn, with_assign=True))
    err_in = (got[3].double() - want[3].double()).abs()
    t_ops = 3.0 * b * n * k * s
    bms, by = bound(nbytes(both, c0, *got[1:]), t_ops)
    out["kmeans_stats"] = dict(
        max_abs_err=err_sums,
        **timed(lambda: kmeans_ops.kmeans_stats(both, c0, block_n=bn), 10),
        plain_ms=time_ms(lambda: kmeans_stats_ref(both, c0, block_n=bn), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=[b, n, s], k=k, block_n=bn, inertia_max_rel_err=float(
            (err_in / want[3].double()).max()), equal_bits=True,
            smem_bytes=kmeans_kernel.stats_smem_bytes(k, s)),
    )

    # kmeans_pair_assign_hist: the final assignment with the built centroids
    # (the narrow route: an FFMA screen); its probe's re-checks and screen
    # error; its outputs the parent's bits.  The bound counts the FFMA
    # screen's 2 operations a (pair, dim) (one fused multiply-add gives the
    # plain bits but for the rare re-check), the plain arithmetic's 3 beside
    # it
    cents = torch.cat([index.centroids1, index.centroids2]).contiguous()
    got = kmeans_ops.kmeans_pair_assign_hist(both, cents, block_n=bn)
    want = kmeans_pair_assign_hist_ref(both, cents, block_n=bn)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("kmeans_pair_assign_hist differs from the plain version")
    same_bits("kmeans_pair_assign_hist", got,
              kmeans_ops.kmeans_pair_assign_hist(both, cents, block_n=bn))
    prints, parent = [fingerprint(t) for t in got], PARENT_PAIR_FINGERPRINT.get(seed)
    if parent not in (None, prints):
        raise AssertionError("kmeans_pair_assign_hist's output differs from the parent tree's")
    nb4 = nbytes(both, cents, *got)
    bms, by = bound(nb4, 2.0 * b * n * k * s)
    out["kmeans_pair_assign_hist"] = dict(
        max_abs_err=0.0,
        **timed(lambda: kmeans_ops.kmeans_pair_assign_hist(both, cents, block_n=bn), 10),
        plain_ms=time_ms(lambda: kmeans_pair_assign_hist_ref(both, cents, block_n=bn), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=[b, n, s], k=k, block_n=bn,
                    smem_bytes=kmeans_kernel.pair_smem_bytes(k, s),
                    fp32_bound_ms=bound(nb4, 3.0 * b * n * k * s)[0], fingerprint=prints,
                    parent_fingerprint=parent, **pair_probe(both, cents)),
    )

    # sc_score compact (row 1) on the fused batches' own inputs: each batch of
    # 1, 8 and 64 queries served once with the op's arguments recorded; its
    # first chunk (thr = -1: every live column survives, count > cap) and its
    # second (the warm pool's minimum), with and without a tombstone mask
    m = q64.shape[0]
    ns = cfg.n_subspaces
    batches = {}
    for m_, chunks in fused.items():
        bc = chunks[0]["cells"].shape[1]
        keep = torch.rand(bc, device=dev, generator=torch.Generator(dev).manual_seed(m_)) > 0.1
        counts = []
        for c in chunks[:2]:
            for kc in (None, keep):
                args = (c["ranks"], c["cuts"], c["cells"], c["thr"], c["limit"], kc)
                got = score_ops.sc_scores_cells_prefilter_compact(*args, cap=c["cap"])
                want = sc_score_cells_prefilter_compact_ref(*args, cap=c["cap"])
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"sc_score compact at m = {m_} differs from the plain "
                                         "version")
                same_bits(f"sc_score compact at m = {m_}", got,
                          score_ops.sc_scores_cells_prefilter_compact(*args, cap=c["cap"]))
                counts.append(int(got[3].max()))
        batches[m_] = dict(chunks=len(chunks), chunk=bc, cap=chunks[0]["cap"],
                           most_survivors=dict(first=counts[0], first_masked=counts[1],
                                               warm=counts[2], warm_masked=counts[3]),
                           **sweep_plan(engine.index, m_, bc))
    if batches[64]["most_survivors"]["first"] <= batches[64]["cap"]:
        raise AssertionError("the first chunk did not overflow its slots")

    def replay_bound(chunks) -> tuple[float, str]:
        """Row 1's bound per launch over a batch's chunks."""
        per = [bound(nbytes(c["ranks"], c["cuts"], c["cells"], c["thr"], c["keep_cols"])
                     + 4 * (c["cells"].shape[1] + 2 * c["cap"] + 1) * c["thr"].shape[0],
                     2.0 * ns * c["thr"].shape[0] * c["cells"].shape[1]) for c in chunks]
        return sum(t for t, _ in per) / len(per), per[0][1]

    in_path = {}
    for m_ in (1, 64):  # a batch's chunks replayed in order, per launch
        chunks = fused[m_]
        t = timed(lambda chunks=chunks: replay_compact(chunks), 10)
        bms, by = replay_bound(chunks)
        in_path[str(m_)] = dict(ms=t["ms"] / len(chunks), call_ms=t["call_ms"] / len(chunks),
                                bound_ms=bms, bound_by=by, launches_per_batch=len(chunks),
                                ms_readings=[r / len(chunks) for r in t["ms_readings"]],
                                device_events_lost=t["device_events_lost"],
                                device_retakes=t["device_retakes"], ms_clock=t["ms_clock"])

    # the L2 route: an index width whose one-query bitmap is past shared memory
    l2 = l2_route_inputs(dev, 16, 341, 8, tiles.block_n)
    plan_l2 = sweep_plan(None, 8, tiles.block_n, ns=16, k_cells=341**2)
    args = (*l2, tiles.block_n, None)
    got = score_ops.sc_scores_cells_prefilter_compact(*args, cap=tiles.survivor_cap)
    want = sc_score_cells_prefilter_compact_ref(*args, cap=tiles.survivor_cap)
    if plan_l2["bitmap_route"] != "l2" or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("sc_score compact on the L2 route differs from the plain version")
    l2_rec = dict(ns=16, sqrt_k=341, m=8, chunk=tiles.block_n, **plan_l2, ms=device_ms(
        lambda: score_ops.sc_scores_cells_prefilter_compact(*args, cap=tiles.survivor_cap),
        20)["ms"])
    del l2, got, want

    # the kernel table's shape: the 64-query batch's first chunk at the
    # threshold of a warm pool (score > Ns/2 survives)
    c = fused[64][0]
    chunk, cap = c["cells"].shape[1], c["cap"]
    thr = torch.full((m,), ns // 2, dtype=torch.int32, device=dev)
    args = (c["ranks"], c["cuts"], c["cells"], thr, chunk, None)
    got = score_ops.sc_scores_cells_prefilter_compact(*args, cap=cap)
    if not all(torch.equal(g, w) for g, w in zip(
            got, sc_score_cells_prefilter_compact_ref(*args, cap=cap))):
        raise AssertionError("sc_score compact differs from the plain version")
    bms, by = bound(nbytes(c["ranks"], c["cuts"], c["cells"], thr, *got), 2.0 * ns * m * chunk)
    out["sc_score_cells_prefilter_compact"] = dict(
        max_abs_err=0.0,
        **timed(lambda: score_ops.sc_scores_cells_prefilter_compact(*args, cap=cap), 50),
        plain_ms=time_ms(lambda: sc_score_cells_prefilter_compact_ref(*args, cap=cap), 10),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, chunk=chunk, cap=cap, ns=ns, cells=engine.index.n_cells,
                    **sweep_plan(engine.index, m, chunk),
                    mean_survivors=float(got[3].float().mean()), equal_bits=True,
                    in_path=in_path, batches_checked=batches, l2_route=l2_rec),
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
        **timed(lambda: gather_ops.gather_rerank_block(ids, data, q64), 50),
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


def pairwise_nan_inf(dev, seed: int, m: int = 8, n: int = 3000, s: int = 16) -> dict:
    """Row 10 on NaN and +-inf coordinates (a NaN and an inf in points and in
    queries, a point of zeros): the card's distances are NaN exactly where
    the plain version's on the CPU are, and equal its other bits (inf
    included); two launches give equal bits."""
    import torch

    from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
    from repro_torch.kernels.pairwise_l2.ref import pairwise_sqdist_ref

    g = torch.Generator().manual_seed(seed)
    x, q = torch.randn(n, s, generator=g) * 3, torch.randn(m, s, generator=g) * 3
    x[n // 2, s - 1], x[n - 1, 0], x[0] = float("nan"), float("-inf"), 0.0
    q[0, s // 2], q[m - 1, s - 1], q[1, 0], q[2, 0] = float("-inf"), float("nan"), float("inf"), 1.0
    got = pairwise_ops.pairwise_sqdist(q.to(dev), x.to(dev))
    again = pairwise_ops.pairwise_sqdist(q.to(dev), x.to(dev))
    want = pairwise_sqdist_ref(q, x)
    nan = want.isnan()
    got = got.cpu()
    if not (torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                                                          want.masked_fill(nan, 0).view(torch.int32))
            and torch.equal(again.view(torch.int32).cpu(), got.view(torch.int32))):
        raise AssertionError("pairwise_sqdist on NaN / inf coordinates differs from the plain version")
    return dict(m=m, n=n, s=s, nan=int(nan.sum()), inf=int(want.isinf().sum()), equal=True)


def sc_linear_inputs(data, q, ns: int):
    """Row 9's inputs on SC-Linear's path: the ``Ns`` contiguous subspace
    views of the data and the queries (strided, no copy) and each query's
    threshold, the ``count``-th smallest of row 10's distances (alpha =
    0.05): ``(qs, xs, tau, count)``."""
    import torch

    from repro_torch.core import subspace as sub
    from repro_torch.core.collision import kth_smallest
    from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops

    spec = sub.contiguous_spec(data.shape[1], ns)
    xs, qs = sub.split_padded(spec, data), sub.split_padded(spec, q)
    count = sub.collision_count(data.shape[0], 0.05)
    tau = torch.stack([kth_smallest(pairwise_ops.pairwise_sqdist(qs[i], xs[i]), count)
                       for i in range(ns)])
    return qs, xs, tau, count


def check_query_kernels(dev, data, index, q64, cfg, tiles, seed: int) -> dict:
    """The kernels of the query modes and SC-Linear against their plain
    versions at their paths' shapes: the scores-only kernel at m = 1, 8 and
    64 over one streaming chunk of 4096 points and over all n (the dense
    mode), the
    keep-mask kernel over one fused chunk, the pairwise kernel at m = 64,
    8 and 1 over all n points of one subspace and on NaN / inf coordinates
    (:func:`pairwise_nan_inf`), and the fused-score kernel at m = 64 over all
    Ns subspaces.  Every output must be equal."""
    import torch

    from repro_torch.core import subspace as sub
    from repro_torch.kernels.pairwise_l2 import kernel as pairwise_kernel
    from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
    from repro_torch.kernels.pairwise_l2.ref import pairwise_sqdist_ref
    from repro_torch.kernels.sc_score import ops as score_ops
    from repro_torch.kernels.sc_score.ref import sc_score_cells_prefilter_ref, sc_score_cells_ref

    out = {}
    n = data.shape[0]
    m, ns = q64.shape[0], cfg.n_subspaces
    ranks, cuts = cell_score_inputs(index, q64)

    # scores only: one streaming chunk, timed as the streaming query launches
    # it (each launch the next chunk of the index, its cell ids not in L2);
    # then the dense mode's one launch over all n columns
    chunk = 4096
    cells = index.cell_ids[:, :chunk]
    got = score_ops.sc_scores_cells(ranks, cuts, cells)
    if not torch.equal(got, sc_score_cells_ref(ranks, cuts, cells)):
        raise AssertionError("sc_score_cells differs from the plain version")
    turn = [0]

    def stream():
        lo = turn[0] % (n // chunk) * chunk
        turn[0] += 1
        return score_ops.sc_scores_cells(ranks, cuts, index.cell_ids[:, lo:lo + chunk])

    def plan(m_: int, bc: int) -> dict:
        return sweep_plan(index, m_, bc)

    full = index.cell_ids
    # the batches of 1 and 8 queries the query modes also serve run other Q
    # instantiations of both passes: each over a streaming chunk and all n
    batches = {}
    for mb in (1, 8):
        ranks_b, cuts_b = cell_score_inputs(index, q64[:mb])
        for cols in (cells, full):
            if not torch.equal(score_ops.sc_scores_cells(ranks_b, cuts_b, cols),
                               sc_score_cells_ref(ranks_b, cuts_b, cols)):
                raise AssertionError(f"sc_score_cells at m = {mb} over {cols.shape[1]} columns "
                                     "differs from the plain version")
        batches[mb] = dict(chunk=plan(mb, chunk), dense=plan(mb, n))
    bms, by = bound(nbytes(ranks, cuts, cells, got), 2.0 * ns * m * chunk)
    out["sc_score_cells"] = dict(
        max_abs_err=0.0, **timed(stream, 100),
        plain_ms=time_ms(lambda: sc_score_cells_ref(ranks, cuts, cells), 20),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, chunk=chunk, ns=ns, cells=index.n_cells, **plan(m, chunk),
                    batches_checked=batches))
    got = score_ops.sc_scores_cells(ranks, cuts, full)
    if not torch.equal(got, sc_score_cells_ref(ranks, cuts, full)):
        raise AssertionError("sc_score_cells (dense) differs from the plain version")
    same_bits("sc_score_cells (dense)", (got,), (score_ops.sc_scores_cells(ranks, cuts, full),))
    bms, by = bound(nbytes(ranks, cuts, full, got), 2.0 * ns * m * n)
    out["sc_score_cells (dense)"] = dict(
        max_abs_err=0.0, **timed(lambda: score_ops.sc_scores_cells(ranks, cuts, full), 10),
        plain_ms=time_ms(lambda: sc_score_cells_ref(ranks, cuts, full), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, n=n, ns=ns, cells=index.n_cells, **plan(m, n), equal_bits=True))
    del got

    # the L2 route: an index width whose one-query bitmap is past shared memory
    l2 = l2_route_inputs(dev, 16, 341, 8, chunk)[:3]
    plan_l2 = sweep_plan(None, 8, chunk, ns=16, k_cells=341**2)
    if plan_l2["bitmap_route"] != "l2" or not torch.equal(score_ops.sc_scores_cells(*l2),
                                                     sc_score_cells_ref(*l2)):
        raise AssertionError("sc_score_cells on the L2 route differs from the plain version")
    out["sc_score_cells"]["detail"]["l2_route"] = dict(
        ns=16, sqrt_k=341, m=8, chunk=chunk, **plan_l2,
        ms=device_ms(lambda: score_ops.sc_scores_cells(*l2), 20)["ms"])
    del l2

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
        **timed(lambda: score_ops.sc_scores_cells_prefilter(ranks, cuts, cells, thr), 100),
        plain_ms=time_ms(lambda: sc_score_cells_prefilter_ref(ranks, cuts, cells, thr), 20),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(m=m, chunk=cells.shape[1], ns=ns, kept=float(got_k.float().mean())),
    )

    # pairwise distances: one subspace of SC-Linear (strided views, no copy),
    # at SC-Linear's batches of 64 and 8 and at 1; NaN and inf coordinates
    spec = sub.contiguous_spec(data.shape[1], ns)
    xs, qs = sub.split_padded(spec, data), sub.split_padded(spec, q64)
    s = xs.shape[2]
    got = pairwise_ops.pairwise_sqdist(qs[0], xs[0])
    want = pairwise_sqdist_ref(qs[0], xs[0])
    if not torch.equal(got, want):
        raise AssertionError("pairwise_sqdist differs from the plain version")
    del want
    by_m = {}
    for mb in (1, 8):
        got_b = pairwise_ops.pairwise_sqdist(qs[0, :mb], xs[0])
        if not (torch.equal(got_b, pairwise_sqdist_ref(qs[0, :mb], xs[0]))
                and torch.equal(got_b, got[:mb])):
            raise AssertionError(f"pairwise_sqdist at m = {mb} differs from the plain version")
        bms_b = bound(nbytes(qs[0, :mb], xs[0], got_b), dist_ops(mb, n, s))[0]
        by_m[mb] = dict(ms=device_ms(lambda mb=mb: pairwise_ops.pairwise_sqdist(qs[0, :mb],
                                                                                 xs[0]), 20)["ms"],
                        bound_ms=bms_b, equal=True)
        del got_b
    nan_inf = pairwise_nan_inf(dev, seed)
    q0, x0 = qs[0].contiguous(), xs[0].contiguous()  # cdist wants dense operands
    bms, by = bound(nbytes(qs[0], xs[0], got), dist_ops(m, n, s))
    out["pairwise_sqdist"] = dict(
        max_abs_err=0.0,
        **timed(lambda: pairwise_ops.pairwise_sqdist(qs[0], xs[0]), 20),
        plain_ms=time_ms(lambda: pairwise_sqdist_ref(qs[0], xs[0]), 3, warmup=1),
        bound_ms=bms, bound_by=by,
        # torch.cdist through its matmul form, squared: one PyTorch call (and
        # a square) for the same function, with TF32 off
        library_ms=time_ms(
            lambda: torch.cdist(q0, x0, compute_mode="use_mm_for_euclid_dist") ** 2, 20),
        detail=dict(m=m, n=n, s=s, vec=pairwise_kernel.vec(xs[0]),
                    items=pairwise_kernel.items(m, n), by_m=by_m, nan_inf=nan_inf,
                    library="torch.cdist(use_mm_for_euclid_dist) ** 2",
                    library_max_abs_err=float(
                        (torch.cdist(q0, x0, compute_mode="use_mm_for_euclid_dist") ** 2
                         - got).abs().max())),
    )
    del q0, x0
    out["pairwise_sqdist"]["detail"].update(
        fingerprint=fingerprint(got), parent_fingerprint=PARENT_PAIRWISE_FINGERPRINT.get(seed))
    if out["pairwise_sqdist"]["detail"]["parent_fingerprint"] not in (None, fingerprint(got)):
        raise AssertionError("pairwise_sqdist's output differs from the parent tree's")
    del got
    out["sc_score"] = check_sc_score(dev, data, q64, ns)
    return out


def check_sc_score(dev, data, q64, ns: int) -> dict:
    """Row 9 (the SC-score kernel: a 3xTF32 screen with an exact re-check
    near each threshold) at SC-Linear's path shape, the thresholds taken
    from row 10's distances (``sc_linear_inputs``): its counts equal the
    plain version's and the collisions of row 10's distances, bit for bit,
    and two launches give equal bits; every instantiation the op can pick
    (16-byte copies on the path's aligned views, 4-byte copies on a copy of
    the data one float off) at m = 1, 8 and 64 equals the plain version; the
    probe instantiation gives the same counts, its re-checks per (pair,
    subspace), and its largest |d~ - d_plain| / delta over every pair, which
    must be <= 0.25 (the margin allows 0.5).  The bound is the bytes (x read
    once, the counts written once), beside the 3xTF32 products' and the
    plain fp32 arithmetic's."""
    import torch

    from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
    from repro_torch.kernels.pairwise_l2.ref import _sq_norms
    from repro_torch.kernels.sc_score import kernel as score_kernel
    from repro_torch.kernels.sc_score import ops as score_ops
    from repro_torch.kernels.sc_score.ref import sc_score_ref

    qs, xs, tau, count = sc_linear_inputs(data, q64, ns)
    m, n, s = qs.shape[1], xs.shape[1], xs.shape[2]
    got = score_ops.sc_scores_fused(qs, xs, tau)
    if not torch.equal(got, sc_score_ref(qs, xs, tau)):
        raise AssertionError("sc_score differs from the plain version")
    on_path = torch.zeros_like(got)
    for i in range(ns):
        on_path += pairwise_ops.pairwise_sqdist(qs[i], xs[i]) <= tau[i][:, None]
    if not torch.equal(got, on_path):
        raise AssertionError("sc_score disagrees with the collisions of pairwise_sqdist")
    del on_path
    same_bits("sc_score", (got,), (score_ops.sc_scores_fused(qs, xs, tau),))

    # every instantiation the op picks: both copy widths at m = 1, 8, 64
    wide = torch.empty((n, data.shape[1] + 1), device=dev)
    wide[:, 1:] = data
    qwide = torch.empty((m, data.shape[1] + 1), device=dev)
    qwide[:, 1:] = q64
    qs1, xs1 = sc_linear_inputs(wide[:, 1:], qwide[:, 1:], ns)[:2]
    instantiations = []
    for vec, (q_, x_) in ((4, (qs, xs)), (1, (qs1, xs1))):
        if score_kernel.fused_vec(q_, x_) != vec:
            raise AssertionError(f"the views meant for vec = {vec} take another copy width")
        for mb in (1, 8, 64):
            t_ = tau[:, :mb].contiguous()
            got_b = score_ops.sc_scores_fused(q_[:, :mb], x_, t_)
            plain = got if mb == m else sc_score_ref(q_[:, :mb], x_, t_)
            if not (torch.equal(got_b, plain) and torch.equal(got_b, got[:mb])):
                raise AssertionError(f"sc_score (vec = {vec}, m = {mb}) differs from the plain "
                                     "version")
            instantiations.append(dict(vec=vec, m=mb, equal=True))
    del got_b

    # the probe: re-checks, and the screen's error against its margin
    probe = score_kernel.sc_score_fused_probe(qs1, xs1, tau)
    if not torch.equal(probe.scores, got):
        raise AssertionError("the probe (vec = 1) differs from the path's counts")
    del probe, qs1, xs1, wide, qwide
    probe = score_kernel.sc_score_fused_probe(qs, xs, tau)
    if not torch.equal(probe.scores, got):
        raise AssertionError("the probe differs from the path's counts")
    mu, eta = score_kernel.fused_screen_margin(s), score_kernel.fused_screen_floor(s)
    ratio = 0.0
    for i in range(ns):
        t = (_sq_norms(qs[i])[:, None] + _sq_norms(xs[i])[None, :]).double()
        err = (probe.screen[i].double() - pairwise_ops.pairwise_sqdist(qs[i], xs[i]).double()).abs()
        ratio = max(ratio, float((err / (mu * t + eta)).max()))
        del t, err
    rechecks = int(probe.rechecks.sum())
    del probe
    if not ratio <= 0.25:
        raise AssertionError(f"sc_score's screen error {ratio} of its margin, above 0.25")
    if rechecks < ns * m:
        raise AssertionError("sc_score re-checked fewer pairs than its thresholds' ties")

    size = nbytes(qs, xs, tau, got)
    t_bytes = size / MEM_BYTES_PER_S * 1e3
    t_tc = 3 * 2.0 * m * n * ns * s / TF32_OPS_PER_S * 1e3
    bms, by = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")
    return dict(
        max_abs_err=0.0,
        **timed(lambda: score_ops.sc_scores_fused(qs, xs, tau), 10),
        plain_ms=time_ms(lambda: sc_score_ref(qs, xs, tau), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(ns=ns, m=m, n=n, s=s, collision_count=count,
                    mean_score=float(got.float().mean()), equal_bits=True,
                    tf32_bound_ms=t_tc, fp32_bound_ms=bound(size, ns * (dist_ops(m, n, s)
                                                                       + 2.0 * m * n))[0],
                    rechecks_per_pair=rechecks / (ns * m * n), rechecks=rechecks,
                    screen_err_over_margin=ratio, margin_mu=mu, margin_eta=eta,
                    instantiations=instantiations, fingerprint=fingerprint(got)),
    )


def port_kernel_names() -> set[str]:
    """The ``__global__`` functions of the imported port's ``csrc/*.cu``."""
    import re

    from repro_torch.kernels import _build

    pat = re.compile(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\s*\(")
    return {k for src in _build.CSRC.glob("*.cu") for k in pat.findall(src.read_text())}


def profile_batch(fn) -> dict:
    """One call of ``fn`` (a served batch) under ``torch.profiler``: wall
    time, the device's busy time (the device events' own time summed;
    operator events, whose device time repeats their kernels', are left out)
    and idle share, the kernels taking the most device time, and the port's
    own kernels with their time and launches."""
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
    names = port_kernel_names()
    port = [r for r in kernels_ if any(f"::{k}{c}" in r[0] for k in names for c in "(<")]
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / wall_us if busy_us else None,
        top=[dict(name=name[:60], ms=t / 1e3, calls=c) for name, t, c in top],
        port_kernels=[dict(name=name[:60], ms=t / 1e3, calls=c) for name, t, c in port],
    )


def compact_in_profile(prof: dict) -> dict:
    """Row 1 in a profiled fused batch (:func:`profile_batch`): its passes'
    device time over the batch, its launches (one compaction pass each) and
    the time per launch."""
    passes = ("sc_bitmap_kernel", "sc_sweep_kernel", "sc_compact_kernel")
    rows = [r for r in prof["port_kernels"] if any(f"::{k}" in r["name"] for k in passes)]
    ms = sum(r["ms"] for r in rows)
    launches = sum(r["calls"] for r in rows if "::sc_compact_kernel" in r["name"])
    return dict(ms=ms, launches=launches, ms_per_launch=ms / launches if launches else None)


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
    over the main path's index, batches of 1, 8 and 64, each answer bitwise
    equal to the fused answer ``answers[m]``; then one streaming batch under
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
            if not rows[m]["bitwise_equal_fused"]:
                raise AssertionError(f"the {mode} mode's answer at m = {m} differs from the "
                                     "fused query's")
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


def assign_ops(n: int, k: int, s: int, b: int = 1) -> float:
    """fp32 operations of nearest-centroid assignment: a difference, a
    square and a sum per (point, centroid, dim), as rows 3-4 count them."""
    return 3.0 * b * n * k * s


def tc_assign_bound(nbytes_: float, n: int, k: int, s: int, b: int = 1) -> tuple[float, str]:
    """The screened assignments' bound (rows 6 and 5): the larger of
    the bytes over the memory rate and its 3xTF32 products, 3 * 2 n k s
    operations, over the tensor cores' TF32 rate, in ms."""
    t_bytes = nbytes_ / MEM_BYTES_PER_S * 1e3
    t_ops = 3 * 2.0 * b * n * k * s / TF32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def screen_probe(x, c, sample: int = 16_384) -> dict:
    """The screened kernel's instruments at one shape (``x: (B, n, s)``,
    ``c: (B, k, s)``): its re-checked pairs per point over all n points (its
    assignments held to the plain version's), and the largest |screen -
    d_plain| / delta_p over the first ``sample`` points of codebook 0 and
    every centroid, which must be <= 0.25 (the margin allows 0.5)."""
    import torch

    from repro_torch.core.distances import sqdist_rowwise
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_batched_ref

    b, n, s = x.shape
    got, rechecks = kmeans_kernel.kmeans_assign_probe(x, c)[:2]
    if not torch.equal(got, kmeans_assign_batched_ref(x, c, block_n=4096)):
        raise AssertionError("the screened kernel's probe differs from the plain version")
    xs = x[:1, :sample].contiguous()
    screen = kmeans_kernel.kmeans_assign_probe(xs, c[:1].contiguous(), screen=True).screen
    d = sqdist_rowwise(xs[0], c[0]).double()
    big = (xs[0].double() ** 2).sum(1) + (c[0].double() ** 2).sum(1).max()
    ratio = float(((screen[0].double() - d).abs()
                   / (kmeans_kernel.screen_margin(s) * big)[:, None]).max())
    if not ratio <= 0.25:
        raise AssertionError(f"screen error {ratio} of its margin, above 0.25")
    return dict(rechecks_per_point=float(rechecks.sum()) / (b * n),
                screen_err_over_margin=ratio, margin_mu=kmeans_kernel.screen_margin(s),
                sampled_points=xs.shape[1])


def narrow_probe(x, c, sample: int = 16_384) -> dict:
    """Row 5's narrow kernel's instruments at one shape (``x: (B, n, s)``,
    ``c: (B, k, s)``, s <= 64): its re-checked pairs per point over all n
    points (its argmins held to the plain version's), and over the first
    ``sample`` points of codebook 0 and every centroid the largest
    |(|x|^2 - 2 t) - d_plain| / delta_p of its screen values t, which must be
    <= 0.25 (the margin allows 0.5), and its best distances, which must equal
    the plain minimum bit for bit."""
    import torch

    from repro_torch.core.distances import sqdist_rowwise
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_batched_ref

    b, n, s = x.shape
    probe = kmeans_kernel.kmeans_assign_narrow_probe(x, c)
    if not torch.equal(probe.assign, kmeans_assign_batched_ref(x, c, block_n=4096)):
        raise AssertionError("the narrow kernel's probe differs from the plain version")
    xs = x[:1, :sample].contiguous()
    small = kmeans_kernel.kmeans_assign_narrow_probe(xs, c[:1].contiguous(), screen=True)
    d = sqdist_rowwise(xs[0], c[0])
    nx = (xs[0].double() ** 2).sum(1)
    big = nx + (c[0].double() ** 2).sum(1).max()
    ratio = float(((nx[:, None] - 2 * small.screen[0].double() - d.double()).abs()
                   / (kmeans_kernel.narrow_margin(s) * big)[:, None]).max())
    if not ratio <= 0.25:
        raise AssertionError(f"narrow screen error {ratio} of its margin, above 0.25")
    if not torch.equal(small.best[0], d.min(-1).values):
        raise AssertionError("the narrow kernel's best distance differs from the plain minimum")
    return dict(rechecks_per_point=float(probe.rechecks.sum()) / (b * n),
                screen_err_over_margin=ratio, margin_mu=kmeans_kernel.narrow_margin(s),
                sampled_points=xs.shape[1], best_equal=True)


def pair_probe(x, c, sample: int = 16_384) -> dict:
    """Row 4's narrow kernel's instruments at one shape (``x: (2Ns, n, s)``,
    ``c: (2Ns, k, s)``, s <= 64): its re-checked (point, half)s per point
    and half over all n points (its outputs held to the plain version's),
    and over the first ``sample`` points of every codebook and every
    centroid the largest |(|x|^2 - 2 t) - d_plain| / delta_p of its screen
    values t, which must be <= 0.25 (the margin allows 0.5)."""
    import torch

    from repro_torch.core.distances import sqdist_rowwise
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign.ref import kmeans_pair_assign_hist_ref

    b, n, s = x.shape
    probe = kmeans_kernel.kmeans_pair_assign_hist_probe(x, c)
    if not all(torch.equal(g, w) for g, w in zip(
            probe[:2], kmeans_pair_assign_hist_ref(x, c, block_n=4096))):
        raise AssertionError("the narrow pair kernel's probe differs from the plain version")
    xs = x[:, :sample].contiguous()
    small = kmeans_kernel.kmeans_pair_assign_hist_probe(xs, c, screen=True)
    ratio = 0.0
    for i in range(b):
        nx = (xs[i].double() ** 2).sum(1)
        big = nx + (c[i].double() ** 2).sum(1).max()
        err = (nx[:, None] - 2 * small.screen[i].double() - sqdist_rowwise(xs[i], c[i]).double())
        delta = kmeans_kernel.narrow_margin(s) * big
        ratio = max(ratio, float((err.abs() / delta[:, None]).max()))
    if not ratio <= 0.25:
        raise AssertionError(f"pair screen error {ratio} of its margin, above 0.25")
    return dict(rechecks_per_point=float(probe.rechecks.sum()) / (b * n),
                max_screen_err_over_margin=ratio, margin_mu=kmeans_kernel.narrow_margin(s),
                sampled_points=xs.shape[1])


def pair_wide_inputs(data, seed: int):
    """Row 4's wide shape: two 262,144-row halves of the data at full width,
    ``(2, 262,144, 128)``, and 256 seeded random centroids of each (a
    65,536-cell histogram, past shared memory)."""
    import torch

    from repro_torch.core.kmeans import init_random

    rows = min(256 * IVF_K, data.shape[0] // 2)  # the IVF sample's size
    halves = torch.stack([data[:rows], data[rows:2 * rows]])
    return halves, init_random(halves, 256, torch.Generator().manual_seed(seed + 5))


def assign_nan_inf(dev, seed: int, n: int = 20_011) -> dict:
    """Rows 3-6, every variant the ops take (narrow and wide for rows 3-5),
    against their plain versions on NaN and +-inf data: integer-valued
    entries (so every sum is exact in any order) with, by codebook, a NaN or
    inf centroid coordinate, NaN or inf points, and both (inf - inf makes a
    NaN distance).  Argmins equal torch.argmin's (the first NaN distance)
    and lie in [0, k); row 3's sums, counts and inertia and row 4's
    histogram equal bit for bit, NaN where the plain version's are."""
    import torch

    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.kmeans_assign.ref import (
        kmeans_assign_batched_ref,
        kmeans_assign_ref,
        kmeans_pair_assign_hist_ref,
        kmeans_stats_ref,
    )

    g = torch.Generator(dev).manual_seed(seed + 40)
    out = {}
    for kind, bad in (("nan", (float("nan"),) * 3),
                      ("inf", (float("inf"), -float("inf"), float("inf")))):
        for s, k in ((16, 256), (8, 50), (70, 40)):
            x = torch.randint(-5, 6, (4, n, s), generator=g, device=dev).float()
            c = torch.randint(-5, 6, (4, k, s), generator=g, device=dev).float()
            c[0, k // 2, s - 1] = bad[0]
            x[1, ::7, 0] = bad[1]
            x[2, 3::7, s - 1] = bad[2]
            c[2, k - 1, s - 1] = bad[2]
            bn = 4096
            want5 = kmeans_assign_batched_ref(x, c, block_n=bn)
            want3 = kmeans_stats_ref(x, c, block_n=bn)
            k4 = min(k, 100)  # the narrow pair kernel holds its k^2 histogram
            want4 = kmeans_pair_assign_hist_ref(x, c[:, :k4].contiguous(), block_n=bn)
            got = {}
            for wide in ((True,) if s > 64 else (False, True)):
                v = "wide" if wide else "narrow"
                got[f"5_{v}"] = kmeans_kernel.kmeans_assign_batched(x, c, wide)
                if not torch.equal(got[f"5_{v}"], want5):
                    raise AssertionError(f"row 5 ({v}) differs from its plain version on {kind}")
                r3 = kmeans_kernel.kmeans_stats(x, c, bn, True, wide)
                for a_, b_ in zip(r3, want3):
                    torch.testing.assert_close(a_, b_, rtol=0, atol=0, equal_nan=True)
                got[f"3_{v}"] = r3[0]
                r4 = kmeans_kernel.kmeans_pair_assign_hist(x, c[:, :k4].contiguous(), wide)
                if not all(torch.equal(a_, b_) for a_, b_ in zip(r4, want4)):
                    raise AssertionError(f"row 4 ({v}) differs from its plain version on {kind}")
                got[f"4_{v}"] = r4[0]
            got["6"] = torch.stack([kmeans_ops.kmeans_assign(x[i], c[i]) for i in range(4)])
            if not torch.equal(got["6"], torch.stack([kmeans_assign_ref(x[i], c[i])
                                                      for i in range(4)])):
                raise AssertionError(f"row 6 differs from its plain version on {kind}")
            for name, a in got.items():
                hi = k4 if name.startswith("4") else k
                if not (int(a.min()) >= 0 and int(a.max()) < hi):
                    raise AssertionError(f"row {name} gave an index outside [0, {hi})")
            out[f"{kind}_s{s}_k{k}"] = dict(
                variants=sorted(got), nonfinite_x=int((~torch.isfinite(x)).sum()),
                nonfinite_c=int((~torch.isfinite(c)).sum()),
                first_nan_taken=int((want5 == k // 2)[0].sum()))
    return dict(cases=out, plain_equal=True)


def screen_adversarial(dev, seed: int) -> dict:
    """Rows 6 and 5-wide against their plain version, bit for bit, on small
    adversarial inputs: exact ties from duplicated centroids, points
    equidistant from mirrored centroids, integer data, a large common
    offset (which re-checks nearly every pair), n = k = s = 1, ragged n, k,
    s, and rows off a 16-byte boundary.  Returns re-checks per point."""
    import torch

    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

    g = torch.Generator(dev).manual_seed(seed + 30)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    cases = {}
    c = randn(50, 40) * 3
    c[25:] = c[:25]
    c[7] = c[3]
    cases["duplicates"] = (c[torch.randint(0, 50, (3000,), generator=g, device=dev)]
                           + 0.5 * randn(3000, 40), c)
    x, v = randint(-20, 21, 2000, 36), randint(-5, 6, 2000, 36)
    cases["mirrored"] = (x, torch.stack([x[:64] + v[:64], x[:64] - v[:64]], 1).reshape(128, 36))
    cases["integer"] = (randint(-30, 31, 4000, 100), randint(-30, 31, 333, 100))
    cases["offset_1e3"] = (1e3 + randn(1000, 128), 1e3 + randn(200, 128))
    cases["one"] = (randn(1, 1), randn(1, 1))
    cases["ragged"] = (randn(1001, 37) * 4, randn(77, 37) * 4)
    cases["unaligned"] = (randn(777 * 64 + 1)[1:].view(777, 64),
                          randn(70 * 64 + 1)[1:].view(70, 64))
    out = {}
    for name, (x, c) in cases.items():
        want = kmeans_assign_ref(x, c)
        got, rechecks = kmeans_kernel.kmeans_assign_probe(x[None], c[None])[:2]
        if not (torch.equal(kmeans_ops.kmeans_assign(x, c), want) and torch.equal(got[0], want)):
            raise AssertionError(f"screened assignment ({name}) differs from its plain version")
        out[name] = float(rechecks.sum()) / x.shape[0]
    if out["offset_1e3"] < 0.9 * 200:
        raise AssertionError("a large common offset should re-check nearly every pair")
    return dict(cases=list(out), rechecks_per_point=out, plain_equal=True)


def kmeans_library_phase(data, seed: int) -> tuple[dict, dict]:
    """PQ8x8 codebook training, IVF1024 coarse assignment over the 1M rows
    and IVF1024 Lloyd training at d = 128 (the K-means library's entry
    points, as its users call them); then rows 5 and 6 against their plain
    versions on the same inputs, and the wide variants of rows 3-5 at the
    IVF shapes.  Returns the path's launches and the kernels' records."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import kmeans as km
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.kmeans_assign.ref import (
        kmeans_assign_batched_ref,
        kmeans_assign_ref,
        kmeans_pair_assign_hist_ref,
        kmeans_stats_ref,
    )

    n, d = data.shape
    dev = data.device
    m_pq, k_pq, k_ivf, iters, bn, ivf_bn = (PQ_M, PQ_K, IVF_K, LLOYD_ITERS, PQ_BLOCK_N,
                                            IVF_BLOCK_N)
    xs, c0 = pq_inputs(data, seed)  # (8, n, 16)
    init_inertia = kmeans_ops.kmeans_stats(xs, c0, block_n=bn)[3]  # before the counted run
    sample = ivf_sample(data, seed)
    n_ivf = sample.shape[0]
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pq = km.kmeans_batched(xs, k_pq, iters, block_n=bn, init_centroids=c0)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t0
    pq_stats = kernels.launch_counts()["kmeans_stats"]
    t0 = time.perf_counter()
    cents = ivf_seeds(data, seed)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lists = km.assign(data, cents)
    torch.cuda.synchronize()
    assign_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf = km.kmeans(sample, k_ivf, iters, block_n=ivf_bn, init_centroids=cents)
    torch.cuda.synchronize()
    ivf_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_launched("kmeans_library", launches)
    stats_launches = dict(pq=pq_stats, ivf=launches["kmeans_stats"] - pq_stats)
    if stats_launches != dict(pq=iters, ivf=iters) or launches["kmeans_assign_batched"] != 2 \
            or launches["kmeans_assign"] != 1:
        raise AssertionError(f"kmeans_library launches: {launches}")
    occupancy = torch.bincount(lists.long(), minlength=k_ivf)
    if not (pq.inertia < init_inertia).all() or pq.cell_counts is not None:
        raise AssertionError("PQ training did not lower every codebook's inertia")

    # rows 5 and 6 against their plain versions on the same inputs
    want5 = kmeans_assign_batched_ref(xs, pq.centroids, block_n=bn)
    want6 = kmeans_assign_ref(data, cents)
    if not (torch.equal(pq.assignments, want5) and torch.equal(lists, want6)):
        raise AssertionError("kmeans_assign(_batched) differs from its plain version")

    # the wide variants at the IVF shapes: row 3 at the kmeans++ start (its
    # plain version's inertia is the start's), row 5 on the trained
    # centroids, row 4 at s = 128 and sqrt_k = 256 on two 262,144-row halves
    x1, c_ivf = sample[None], cents[None]
    got3 = kmeans_ops.kmeans_stats(x1, c_ivf, block_n=ivf_bn, with_assign=True)
    want3 = kmeans_stats_ref(x1, c_ivf, block_n=ivf_bn)
    err3 = stats_errors("kmeans_stats (wide)", x1, got3, want3)
    same_bits("kmeans_stats (wide)", got3,
              kmeans_ops.kmeans_stats(x1, c_ivf, block_n=ivf_bn, with_assign=True))
    # row 3 at PQ8x8's shape, from the training's start
    got3p = kmeans_ops.kmeans_stats(xs, c0, block_n=bn, with_assign=True)
    err3p = stats_errors("kmeans_stats (pq)", xs, got3p, kmeans_stats_ref(xs, c0, block_n=bn))
    same_bits("kmeans_stats (pq)", got3p, kmeans_ops.kmeans_stats(xs, c0, block_n=bn,
                                                                 with_assign=True))
    ivf_init_inertia = float(want3[3][0])
    if not float(ivf.inertia) < ivf_init_inertia:
        raise AssertionError("IVF1024 training did not lower the inertia of its kmeans++ start")
    want5w = kmeans_assign_batched_ref(x1, ivf.centroids[None], block_n=ivf_bn)
    if not torch.equal(ivf.assignments[None], want5w):
        raise AssertionError("kmeans_assign_batched (wide) differs from its plain version")
    halves, c4 = pair_wide_inputs(data, seed)
    got4 = kmeans_ops.kmeans_pair_assign_hist(halves, c4, block_n=ivf_bn)
    if not all(torch.equal(g, w) for g, w in zip(
            got4, kmeans_pair_assign_hist_ref(halves, c4, block_n=ivf_bn))):
        raise AssertionError("kmeans_pair_assign_hist (wide) differs from its plain version")
    same_bits("kmeans_pair_assign_hist (wide)", got4,
              kmeans_ops.kmeans_pair_assign_hist(halves, c4, block_n=ivf_bn))
    ivf_lists = torch.bincount(ivf.assignments.long(), minlength=k_ivf)
    emit(dict(phase="kmeans_library",
              pq=dict(codebooks=m_pq, k=k_pq, sub_dim=d // m_pq, iters=iters, block_n=bn,
                      seconds=pq_s, init_inertia=init_inertia.tolist(),
                      final_inertia=pq.inertia.tolist()),
              ivf=dict(lists=k_ivf, d=d, pp_sample=32 * k_ivf, pp_seconds=pp_s,
                       assign_ms=assign_s * 1e3, largest_list=int(occupancy.max()),
                       smallest_list=int(occupancy.min()),
                       empty_lists=int((occupancy == 0).sum())),
              ivf_training=dict(sample=n_ivf, iters=iters, block_n=ivf_bn, seconds=ivf_s,
                                init_inertia=ivf_init_inertia, final_inertia=float(ivf.inertia),
                                largest_list=int(ivf_lists.max()),
                                empty_lists=int((ivf_lists == 0).sum())),
              launches=launches, stats_launches=stats_launches, plain_equal=True))

    def cdist_argmin(a, b):
        return torch.cdist(a, b, compute_mode="use_mm_for_euclid_dist").argmin(-1)

    recs = {}
    cases = (
        ("kmeans_assign_batched", (xs, pq.centroids),
         lambda: kmeans_ops.kmeans_assign_batched(xs, pq.centroids, block_n=bn),
         lambda: kmeans_assign_batched_ref(xs, pq.centroids, block_n=bn),
         assign_ops(n, k_pq, d // m_pq, m_pq), 10),
        ("kmeans_assign", (data, cents), lambda: kmeans_ops.kmeans_assign(data, cents),
         lambda: kmeans_assign_ref(data, cents), assign_ops(n, k_ivf, d), 10),
        ("kmeans_assign_batched (wide)", (x1, ivf.centroids[None]),
         lambda: kmeans_ops.kmeans_assign_batched(x1, ivf.centroids[None], block_n=ivf_bn),
         lambda: kmeans_assign_batched_ref(x1, ivf.centroids[None], block_n=ivf_bn),
         assign_ops(n_ivf, k_ivf, d), 5),
    )
    # the screened kernel (rows 6 and 5-wide): re-checks and screen error at
    # the IVF shapes, then the adversarial set; every record in probes takes
    # the 3xTF32 bound, its fp32 one kept beside it
    probes = {"kmeans_assign": screen_probe(data[None], cents[None]),
              "kmeans_assign_batched (wide)": screen_probe(x1, ivf.centroids[None])}
    adversarial = screen_adversarial(dev, seed)
    emit(dict(phase="screened_assign", ivf=probes, adversarial=adversarial,
              ivf_best_distance=best_distance_check(x1, c_ivf)))
    # row 5 narrow (the tensor-core screen with the codebook resident) at the
    # PQ shape, and rows 3-6 on NaN and inf data
    probes["kmeans_assign_batched"] = narrow_probe(xs, pq.centroids)
    emit(dict(phase="narrow_assign", pq=probes["kmeans_assign_batched"]))
    emit(dict(phase="assign_nan_inf", **assign_nan_inf(dev, seed)))
    for name, args, fn, plain, ops, reps in cases:
        out = fn()
        lib = cdist_argmin(*args)
        bms, by = bound(nbytes(*args, out), ops)
        detail = dict(shape=list(args[0].shape), k=args[1].shape[-2],
                      library=LIBRARY[name.split(" ")[0]],
                      library_disagrees=int((lib != out).sum()))
        if name in probes:  # the tensor-core bound, the fp32 one kept beside it
            b_, n_, s_ = (1, *args[0].shape) if args[0].dim() == 2 else args[0].shape
            detail.update(probes[name], fp32_bound_ms=bms)
            bms, by = tc_assign_bound(nbytes(*args, out), n_, args[1].shape[-2], s_, b_)
        recs[name] = dict(
            max_abs_err=0.0, **timed(fn, reps), plain_ms=time_ms(plain, 1, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=time_ms(lambda: cdist_argmin(*args), 3),
            detail=detail,
        )
        del lib
    # row 3 wide: its argmins are the screened kernel's, so its bound is
    # theirs (3xTF32), the fp32 one kept beside it; PQ's is the fp32 one
    nb3 = nbytes(x1, c_ivf, *got3[1:])
    bms, by = tc_assign_bound(nb3, n_ivf, k_ivf, d)
    recs["kmeans_stats (wide)"] = dict(
        max_abs_err=err3, **timed(lambda: kmeans_ops.kmeans_stats(x1, c_ivf, block_n=ivf_bn), 5),
        plain_ms=time_ms(lambda: kmeans_stats_ref(x1, c_ivf, block_n=ivf_bn), 1, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=list(x1.shape), k=k_ivf, block_n=ivf_bn, equal_bits=True,
                    launches=stats_launches["ivf"],
                    fp32_bound_ms=bound(nb3, assign_ops(n_ivf, k_ivf, d))[0]))
    bms, by = bound(nbytes(xs, c0, *got3p[1:]), assign_ops(n, k_pq, d // m_pq, m_pq))
    recs["kmeans_stats (pq)"] = dict(
        max_abs_err=err3p, **timed(lambda: kmeans_ops.kmeans_stats(xs, c0, block_n=bn), 5),
        plain_ms=time_ms(lambda: kmeans_stats_ref(xs, c0, block_n=bn), 1, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=list(xs.shape), k=k_pq, block_n=bn, equal_bits=True,
                    launches=stats_launches["pq"]))
    # row 4 wide: its argmins are the screened kernel's, so its bound is
    # theirs (3xTF32), the fp32 one kept beside it
    nb4 = nbytes(halves, c4, *got4)
    bms, by = tc_assign_bound(nb4, n_ivf, 256, d, 2)
    recs["kmeans_pair_assign_hist (wide)"] = dict(
        max_abs_err=0.0,
        **timed(lambda: kmeans_ops.kmeans_pair_assign_hist(halves, c4, block_n=ivf_bn), 5),
        plain_ms=time_ms(lambda: kmeans_pair_assign_hist_ref(halves, c4, block_n=ivf_bn), 1,
                         warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=list(halves.shape), k=256, cells=256 * 256, block_n=ivf_bn,
                    equal_bits=True, fp32_bound_ms=bound(nb4, assign_ops(n_ivf, 256, d, 2))[0]))
    return launches, recs


def same_bits(name: str, first, second) -> None:
    """Fail unless two launches of a kernel gave the same bits."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches gave different bits")


def best_distance_check(x, c, chunk: int = 32_768) -> dict:
    """The screened kernel's d* (row 3 wide reads it for the inertia) at
    ``x: (1, n, s)``, ``c: (1, k, s)`` against the plain version's minimum
    distance (``sqdist_rowwise``, the plain assignment's arithmetic), bit for
    bit, and its argmins against ``kmeans_assign_ref``'s."""
    import torch

    from repro_torch.core.distances import sqdist_rowwise
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

    probe = kmeans_kernel.kmeans_assign_probe(x, c)
    dmin = torch.cat([sqdist_rowwise(x[0, i:i + chunk], c[0]).min(-1).values
                      for i in range(0, x.shape[1], chunk)])
    if not torch.equal(probe.assign[0], kmeans_assign_ref(x[0], c[0])):
        raise AssertionError("the screened kernel's argmins differ from kmeans_assign_ref's")
    if not torch.equal(probe.best[0], dmin):
        raise AssertionError("the screened kernel's d* differs from the plain minimum distance")
    return dict(points=x.shape[1], best_equal=True, mean_best=float(dmin.double().mean()))


def stats_errors(name: str, x, got, want) -> float:
    """Hold a statistics kernel's output against its plain version's:
    assignments and counts equal, sums within 1e-5 * sum |terms| (fp32 sums
    in another order), inertia within 1e-5 relative.  Returns the largest
    absolute error of the sums."""
    import torch

    a, sums, counts, inertia = got
    b, _, s = x.shape
    k = sums.shape[1]
    if not (torch.equal(a, want[0]) and torch.equal(counts, want[2])):
        raise AssertionError(f"{name}: assignments or counts differ from the plain version")
    mag = torch.zeros((b * k, s), dtype=torch.float64, device=x.device)
    mag.index_add_(0, (a.long() + torch.arange(b, device=x.device)[:, None] * k).reshape(-1),
                   x.abs().double().reshape(-1, s))
    err = (sums.double() - want[1].double()).abs()
    if not (err <= 1e-5 * mag.reshape(b, k, s)).all():
        raise AssertionError(f"{name}: sums outside 1e-5 * sum |terms|")
    if not ((inertia.double() - want[3].double()).abs() <= 1e-5 * want[3].double()).all():
        raise AssertionError(f"{name}: inertia outside 1e-5 relative")
    return float(err.max())


def lifecycle_phase(data, q64, gt, index, policy, seed: int, k: int) -> dict:
    """The index lifecycle at 1M: a minibatch build served by the fused
    engine; the main path's index in a mutable engine taking 25 inserts of
    4,000 points and one delete of 50,000 ids between batches of 1, 8 and
    64 in the fused and dense modes, with checks (a)-(f); then a save and a
    load of the mutated index on the card.  Returns the path's launches."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import EnginePolicy, SuCoConfig, SuCoEngine, SuCoIndex, build_index, kernels
    from repro_torch.data import gaussian_mixture, recall
    from repro_torch.kernels import _build

    dev = data.device
    n, d = data.shape
    kernels.reset_launch_counts()

    # 1. minibatch build (kmeans++ seeds, sampled steps, full-data final pass)
    t0 = time.perf_counter()
    mb_index = build_index(data, SuCoConfig(build_mode="minibatch"))
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    mb_launches = kernels.launch_counts()
    mb_engine = SuCoEngine(data, mb_index, policy, device=dev)
    mb_recall = recall(mb_engine.query(q64, k).ids.cpu().numpy(), gt)
    del mb_engine, mb_index

    # 2. mutation: the main path's index in a mutable engine, a dense sibling
    # at n = 1M: capacity 1.1M, 25 inserts of 4,000, 25,000 + 25,000 deletes
    cap, n_new = n + n // 10, n // 10
    per_insert = n_new // 25
    eng = SuCoEngine(data, index, policy, capacity=cap, device=dev)
    dense = SuCoEngine(eng.x, eng.index, EnginePolicy(alpha=policy.alpha, beta=policy.beta,
                                                      mode="dense"), device=dev)
    sizes = (1, 8, 64)
    warm = {"fused": eng.warmup(batch_sizes=sizes, ks=(k,)),
            "dense": dense.warmup(batch_sizes=sizes, ks=(k,))}
    buckets = {"fused": eng.stats().buckets, "dense": dense.stats().buckets}
    loaded = _build.loaded()

    def serve():
        rows = {}
        for mode, e in (("fused", eng), ("dense", dense)):
            for m in sizes:
                syncs0 = e.stats().host_syncs
                lat, res = serve_times(lambda m=m: e.query(q64[:m], k))
                if e.index.tombstone[res.ids.long()].any():
                    raise AssertionError(f"(a) a deleted or empty slot in a {mode} answer")
                rows[f"{mode}_{m}"] = dict(median_ms=float(np.median(lat)), latency_ms=lat,
                                           host_syncs_per_batch=(e.stats().host_syncs - syncs0)
                                           / len(lat))
        return rows

    before = serve()
    new = torch.from_numpy(gaussian_mixture(n_new, d, seed + 2)).to(dev)
    insert_ms = []
    for lo in range(0, n_new, per_insert):
        t0 = time.perf_counter()
        eng.insert(new[lo:lo + per_insert])
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t0) * 1e3)
    rng = np.random.default_rng(seed + 3)
    half = n_new // 4  # deleted of the original points, and of the inserted ones
    dead = np.concatenate([rng.choice(n, half, replace=False),
                           n + rng.choice(n_new, half, replace=False)])
    t0 = time.perf_counter()
    newly = eng.delete(dead)
    torch.cuda.synchronize()
    delete_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    again = eng.delete(dead)  # idempotent: the same work, nothing newly dead
    torch.cuda.synchronize()
    redelete_ms = (time.perf_counter() - t0) * 1e3
    if newly != 2 * half or again != 0 or eng.n_live != n + n_new - 2 * half:
        raise AssertionError(f"delete: {newly} then {again} newly dead, {eng.n_live} live")
    dense._rebind(eng.x, eng.index, n_live=eng.n_live, next_slot=eng.n_points - eng.free_slots)
    after = serve()

    idx = eng.index
    live = ~idx.tombstone
    # (b) inserted live points find their own slot first, at distance 0
    alive_new = np.setdiff1d(np.arange(n, n + n_new), dead)[:64]
    own = eng.query(eng.x[torch.from_numpy(alive_new).to(dev)], k)
    own_ok = bool((own.ids[:, 0].cpu().numpy() == alive_new).all()
                  and (own.dists[:, 0] == 0).all())
    # (c) cell_counts is the per-subspace bincount of the live cell ids
    counts_ok = all(torch.equal(idx.cell_counts[i], torch.bincount(
        idx.cell_ids[i][live].long(), minlength=idx.n_cells).to(torch.int32))
        for i in range(idx.spec.n_subspaces))
    # (d) a CPU engine over the same mutated (x, index) gives the same answers
    t0 = time.perf_counter()
    cpu_eng = SuCoEngine(eng.x.cpu(), idx.to("cpu"), EnginePolicy(
        alpha=policy.alpha, beta=policy.beta, tiles=eng.tiles_for(8, k)), device="cpu")
    cpu_check = same_answers(eng.query(q64[:8], k), cpu_eng.query(q64[:8].cpu(), k))
    cpu_check["seconds"] = time.perf_counter() - t0
    del cpu_eng
    # (e) recall@10 at m = 64 against an exact k-NN over the live points
    xd = eng.x.double()
    dist = ((q64.double() ** 2).sum(1)[:, None] + (xd ** 2).sum(1)[None, :]
            - 2 * q64.double() @ xd.T)
    dist[:, ~live] = float("inf")
    gt_live = torch.sort(dist, dim=1, stable=True).indices[:, :k].cpu().numpy()
    del xd, dist
    rec_after = recall(eng.query(q64, k).ids.cpu().numpy(), gt_live)
    # (f) warm state: no (bucket, k) pair new, no kernel library built or loaded again
    rewarm = {"fused": eng.warmup(batch_sizes=sizes, ks=(k,)),
              "dense": dense.warmup(batch_sizes=sizes, ks=(k,))}
    warm_ok = (rewarm == {"fused": 0, "dense": 0}
               and buckets == {"fused": eng.stats().buckets, "dense": dense.stats().buckets}
               and _build.build_all() == [] and _build.loaded() == loaded)
    launches = kernels.launch_counts()
    missing = [name for name in LIFECYCLE_KERNELS if launches[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the lifecycle path: {missing}")

    # 3. save and load on the card
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "index.npz"
        t0 = time.perf_counter()
        idx.save(path, SuCoConfig(), extras={"next_slot": np.asarray(cap - eng.free_slots)})
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        t0 = time.perf_counter()
        back = SuCoIndex.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    roundtrip_ok = all(torch.equal(getattr(back, f), getattr(idx, f)) for f in (
        "centroids1", "centroids2", "cell_ids", "cell_counts", "tombstone"))

    checks = dict(a_no_dead_slot_answered=True, b_own_slot_first=own_ok,
                  c_counts_equal_live_bincount=counts_ok,
                  d_cpu_same_answers=True, e_recall_at_10=rec_after, f_warm_state=warm_ok)
    emit(dict(phase="lifecycle",
              minibatch=dict(build_seconds=mb_s, recall_at_10=mb_recall, launches=mb_launches),
              mutation=dict(capacity=cap, inserted=n_new, insert_batches=len(insert_ms),
                            insert_ms=insert_ms, insert_median_ms=float(np.median(insert_ms)),
                            delete_ms=delete_ms, redelete_ms=redelete_ms, deleted=newly,
                            n_live=eng.n_live,
                            free_slots=eng.free_slots,
                            insert_inertia_per_point=eng.insert_inertia_per_point,
                            warmup_new_pairs=warm, serve_before=before, serve_after=after,
                            cpu_recheck=cpu_check),
              save_load=dict(seconds_save=save_s, seconds_load=load_s, bytes=size,
                             bit_identical=roundtrip_ok),
              checks=checks, launches=launches))
    if mb_recall < 0.90:
        raise AssertionError(f"minibatch-built index recall@10 {mb_recall} below 0.90")
    if not (own_ok and counts_ok and warm_ok and roundtrip_ok) or rec_after < 0.95:
        raise AssertionError(f"lifecycle checks failed: {checks}, round trip {roundtrip_ok}")
    return launches


def serve_trace(pool, mix: dict, rng) -> list[list[tuple]]:
    """A mix's requests as bursts of ``(query, k)``, the queries drawn from
    ``pool`` (deterministic in ``rng``)."""
    bursts = []
    for b in range(mix["bursts"]):
        size = int(mix["sizes"][b % len(mix["sizes"])])
        bursts.append([(pool[int(rng.integers(0, len(pool)))], int(rng.choice(mix["ks"])))
                       for _ in range(size)])
    return bursts


def replay(server, bursts, engine) -> dict:
    """Submit each burst and take one step after it, then drain: the
    completed requests, ``latency_summary``, steps and the engine's host
    synchronisations a batch."""
    from repro_torch.serve import AnnRequest, latency_summary

    st0 = engine.stats()
    rid = 0
    for burst in bursts:
        server.submit_many([AnnRequest(rid + i, q, k=k) for i, (q, k) in enumerate(burst)])
        rid += len(burst)
        server.step()
    server.run_until_drained()
    st1 = engine.stats()
    batches = st1.batches - st0.batches
    if len(server.completed) != rid or not all(r.done for r in server.completed):
        raise AssertionError(f"{type(server).__name__}: a request was not answered")
    return dict(requests=rid, steps=len(server.steps), batches=batches,
                host_syncs_per_batch=(st1.host_syncs - st0.host_syncs) / max(batches, 1),
                summary=latency_summary(server.completed))


def ann_serve_phase(x_np, q64, gt, engine, seed: int, k: int) -> dict:
    """The ANN serving layer (``repro_torch.serve.ann``) over the main path's
    fused engine: a 2-level degradation ladder warmed for batches of 1-16 at
    k = 5 and 10; the JAX package's three traffic mixes through the
    synchronous and the pipelined server (answers equal request by
    request); a forced 0, 1, 2, 1, 0 ladder cycle over the 64 queries, each
    level's success rate held to its Theorem-2 floor; an overload burst
    under the controller; an autoscaled engine replaying ``mixed_batch``;
    and one sync step and one async window under the profiler.  No (bucket,
    k) pair and no kernel library may be added after the warm-up.  Returns
    the path's launches."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.suco import padding_waste
    from repro_torch.data import make_queries, recall
    from repro_torch.kernels import _build
    from repro_torch.serve import (AnnRequest, AnnServer, AsyncAnnServer, DegradationLadder,
                                   OverloadController, latency_summary)

    mb = SERVE_MAX_BATCH
    t_phase = time.perf_counter()
    engine.policy.reset_traffic()  # the autoscaler sees this phase's traffic alone
    kernels.reset_launch_counts()

    # 1. warm up the ladder
    t0 = time.perf_counter()
    ladder = DegradationLadder(engine, levels=2)
    ladder_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = ladder.warmup(batch_sizes=range(1, mb + 1), ks=(5, k))
    warm_s = time.perf_counter() - t0
    executables, loaded = ladder.compile_count, _build.loaded()
    levels = [dict(level=lv, alpha=e.policy.alpha, beta=e.policy.beta,
                   quality_bound=ladder.quality_bound(lv, k))
              for lv, e in enumerate(ladder.engines)]

    def warm_state(where: str) -> None:
        if ladder.compile_count != executables or _build.loaded() != loaded:
            raise AssertionError(f"{where}: (bucket, k) pairs {ladder.compile_count} (warm "
                                 f"{executables}), libraries {_build.loaded()} (warm {loaded})")

    # 2. the JAX package's three mixes, sync and pipelined over the same trace
    pool = make_queries(x_np, 1024, seed=seed + 2)
    mixes = {}
    for i, mix in enumerate(SERVE_MIXES):
        bursts = serve_trace(pool, mix, np.random.default_rng(seed + 10 + i))
        sync, pipe = AnnServer(engine, max_batch=mb), AsyncAnnServer(engine, max_batch=mb, depth=2)
        rec = {"sync": replay(sync, bursts, engine), "async": replay(pipe, bursts, engine)}
        want = {r.rid: r.ids for r in sync.completed}
        rec["async_ids_equal_sync"] = all(np.array_equal(r.ids, want[r.rid])
                                          for r in pipe.completed)
        rec["async_dispatch_over_step_median"] = float(np.median(
            [s.dispatch_s / s.step_s for s in pipe.steps if s.step_s > 0]))
        # an async step_s spans the window (dispatch to retire); its dispatch
        # alone against a sync step says what the window overlaps
        rec["sync_step_ms_median"] = float(np.median([s.step_s for s in sync.steps])) * 1e3
        rec["async_dispatch_ms_median"] = float(np.median([s.dispatch_s for s in pipe.steps])) * 1e3
        rec["batch_sizes"] = sorted({s.n_requests for s in sync.steps})
        mixes[mix["name"]] = rec
        if not rec["async_ids_equal_sync"]:
            raise AssertionError(f"{mix['name']}: async answers differ from sync answers")
        warm_state(mix["name"])

    # 3. the forced 0, 1, 2, 1, 0 cycle over the 64 queries, k = 10
    q_np = q64.cpu().numpy()
    server = AnnServer(engine, max_batch=mb, ladder=ladder)
    cycle = []
    for level in (0, 1, 2, 1, 0):
        server.level = level
        c0 = kernels.launch_counts()
        n0 = len(server.completed)
        server.submit_many([AnnRequest(n0 + i, q_np[i], k=k) for i in range(len(q_np))])
        server.run_until_drained()
        c1 = kernels.launch_counts()
        done = sorted(server.completed[n0:], key=lambda r: r.rid)
        ids = np.stack([r.ids for r in done])
        success = float(np.mean([int(gt[i, 0]) in set(ids[i].tolist()) for i in range(len(ids))]))
        bound_ = ladder.quality_bound(level, k)
        row = dict(level=level, success_rate=success, quality_bound=bound_,
                   recall_at_10=recall(ids, gt),
                   served_at_level=all(r.degrade_level == level and r.quality_bound == bound_
                                       for r in done),
                   launches={n_: c1[n_] - c0[n_] for n_ in ANN_SERVE_KERNELS})
        cycle.append(row)
        if success < bound_ or not row["served_at_level"]:
            raise AssertionError(f"ladder level {level}: success rate {success} below its "
                                 f"bound {bound_}, or an answer without the level's bound")
        if min(row["launches"].values()) < 1:
            raise AssertionError(f"ladder level {level} did not launch rows 1 and 2: {row}")
    warm_state("ladder cycle")

    # 4. an overload burst under the controller
    rng = np.random.default_rng(seed + 20)
    burst = AnnServer(engine, max_batch=mb, ladder=ladder,
                      controller=OverloadController(high_depth=4, low_depth=1))
    burst.submit_many([AnnRequest(i, pool[int(rng.integers(0, len(pool)))], k=k)
                       for i in range(SERVE_OVERLOAD_REQUESTS)])
    burst.run_until_drained()
    s_burst = latency_summary(burst.completed)
    if len(burst.completed) != SERVE_OVERLOAD_REQUESTS or s_burst["n_degraded"] < 1:
        raise AssertionError(f"overload burst: {s_burst}")
    overload = dict(requests=SERVE_OVERLOAD_REQUESTS, steps=len(burst.steps),
                    levels=[s.level for s in burst.steps], n_degraded=s_burst["n_degraded"],
                    quality_bound_min=s_burst["quality_bound_min"], summary=s_burst)
    warm_state("overload burst")

    # 5. autoscale: the observed traffic's buckets, warmed, then mixed_batch again
    observed = {int(m): int(c) for m, c in sorted(engine.policy.traffic.items())}
    auto = engine.autoscaled()
    auto_fresh = auto.warmup(None, ks=(5, k))
    auto_exec, auto_loaded = auto.compile_count, _build.loaded()
    bursts = serve_trace(pool, SERVE_MIXES[1], np.random.default_rng(seed + 11))
    auto_rec = replay(AsyncAnnServer(auto, max_batch=mb, depth=2), bursts, auto)
    if auto.compile_count != auto_exec or _build.loaded() != auto_loaded:
        raise AssertionError("the autoscaled engine met a (bucket, k) pair it had not warmed")
    autoscale = dict(observed=observed, default_buckets=list(engine.policy.batch_buckets),
                     proposed_buckets=list(auto.policy.batch_buckets),
                     padding_waste_default=padding_waste(observed, engine.policy.batch_buckets),
                     padding_waste_autoscaled=padding_waste(observed, auto.policy.batch_buckets),
                     warmup_new_pairs=auto_fresh, replay=auto_rec)
    del auto

    # 6. one sync step and one full async window under the profiler
    def sync_step():
        one = AnnServer(engine, max_batch=mb)
        one.submit_many([AnnRequest(i, pool[i], k=k) for i in range(mb)])
        one.step()

    def async_window():
        win = AsyncAnnServer(engine, max_batch=mb, depth=2)
        win.submit_many([AnnRequest(i, pool[i], k=k) for i in range(3 * mb)])
        win.run_until_drained()

    profiles = dict(sync_step=profile_batch(sync_step), async_window=profile_batch(async_window))
    warm_state("profiles")
    launches = kernels.launch_counts()
    emit(dict(phase="ann_serve", seconds=time.perf_counter() - t_phase, max_batch=mb,
              ladder_seconds=ladder_s,
              warmup_seconds=warm_s, warmup_new_pairs=fresh, executables=executables,
              libraries_loaded=list(loaded), m_stat=ladder.m_stat, sigma_stat=ladder.sigma_stat,
              levels=levels, mixes=mixes, cycle=cycle,
              overload=overload, autoscale=autoscale, profile=profiles,
              stats=engine.stats()._asdict(), launches=launches))
    missing = [name for name in ANN_SERVE_KERNELS if launches[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the ann_serve path: {missing}")
    return launches


#: the kernels the durable mutable serving path runs: every insert's
#: assignment, the drift baseline and the minibatch re-cluster (row 3), every
#: served batch and warm-up in the fused mode (rows 1 and 2)
MUTABLE_SERVE_KERNELS = ("sc_score_cells_prefilter_compact", "gather_rerank", "kmeans_stats")
MUTABLE_CAPACITY, MUTABLE_INSERTS, MUTABLE_INSERT_ROWS, MUTABLE_DELETES = 1_200_000, 25, 4_000, 50_000
DRILL_N = 65_536


def serve_burst(server, pool, rng, rid0: int, size: int = 8, k: int = 10) -> list:
    """One ``steady_b8`` burst: ``size`` single-query requests submitted at
    once, served in one step and retired (the synchronous server copies the
    answers to the host)."""
    from repro_torch.serve import AnnRequest

    reqs = [AnnRequest(rid0 + i, pool[int(rng.integers(0, len(pool)))], k=k)
            for i in range(size)]
    server.submit_many(reqs)
    server.step()
    if not all(r.done for r in reqs):
        raise AssertionError(f"a burst was not answered: {[r.error for r in reqs]}")
    return reqs


def latencies(reqs) -> dict:
    """p50 / p99 / max of requests' host-clock latencies, in ms."""
    import numpy as np

    lat = np.asarray([r.latency_s for r in reqs]) * 1e3
    return dict(requests=len(reqs), p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), max_ms=float(lat.max()))


def stream_shares(trace_path: Path, window: str) -> dict:
    """Per CUDA stream, the device's busy time inside the host span of the
    ``record_function`` named ``window`` in a chrome trace: kernels, copies
    and sets on that stream, clipped to the span; its busy and idle shares;
    and the union over streams."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == window and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    if not span:
        raise AssertionError(f"the trace has no {window!r} span")
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    by_stream: dict[int, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b > a:
            by_stream.setdefault(int(e.get("args", {}).get("stream", -1)), []).append((a, b))

    def union(iv):
        total, end = 0.0, -1e30
        for a, b in sorted(iv):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    wall = t1 - t0
    streams = {str(s): dict(busy_ms=union(iv) / 1e3, busy_share=union(iv) / wall,
                            idle_share=1 - union(iv) / wall, events=len(iv))
               for s, iv in sorted(by_stream.items())}
    every = union([x for iv in by_stream.values() for x in iv])
    return dict(window_ms=wall / 1e3, streams=streams, device_busy_share=every / wall,
                device_idle_share=1 - every / wall)


def mutable_serve_phase(x_np, data, q64, index, policy, seed: int, k: int) -> dict:
    """The durable mutable serving stack (``repro_torch.serve.mutation``,
    ``durability``, ``chaos``) over the main path's index at 1M: a mutable
    engine (capacity 1.2M) under a 2-level ladder, ``AnnServer``,
    ``MutationManager`` and a group-commit ``Durability`` root; 25 inserts of
    4,000 and a delete of 50,000 keys between ``steady_b8`` bursts; the drift
    monitor's fill reason; ``reindex_async`` prepared on the manager's stream
    while this thread serves bursts, then committed (with its snapshot), held
    bit for bit to a synchronous build of the same gather; two more inserts,
    a kill and ``recover`` on the card, bit for bit; then ``recovery_drill``
    at every crash point under both fsync policies at n = 65,536.  One JSON
    line a step; returns the phase's launches."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import EnginePolicy, SuCoConfig, SuCoEngine, build_index, kernels
    from repro_torch.data import gaussian_mixture, make_queries
    from repro_torch.kernels import _build
    from repro_torch.serve import (CRASH_POINTS, AnnServer, DegradationLadder, Durability,
                                   DurabilityConfig, MutationManager, drill_steps, recover,
                                   recovery_drill)
    from repro_torch.serve.durability import fingerprint_diff, state_fingerprint

    dev = data.device
    n, d = data.shape
    mb = SERVE_MAX_BATCH
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    pool = make_queries(x_np, 1024, seed=seed + 30)
    rng = np.random.default_rng(seed + 31)
    rid = [0]

    def serve(srv, count=1):
        out = []
        for _ in range(count):
            out += serve_burst(srv, pool, rng, rid[0], 8, k)
            rid[0] += 8
        return out

    def answers(engine):
        """The 64 queries' ids and distances, 16 a batch (a warmed bucket)."""
        res = [engine.query(q64[i:i + mb], k) for i in range(0, len(q64), mb)]
        return torch.cat([r.ids for r in res]).cpu(), torch.cat([r.dists for r in res]).cpu()

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    root = Path(tempfile.mkdtemp(prefix="suco-durable-"))
    try:
        # 1. the stack, a group-commit root with its worker, the baseline snapshot
        t0 = time.perf_counter()
        eng = SuCoEngine(data, index, policy, capacity=MUTABLE_CAPACITY, device=dev)
        ladder = DegradationLadder(eng, levels=2)
        fresh = ladder.warmup(batch_sizes=range(1, mb + 1), ks=(k,))
        server = AnnServer(eng, max_batch=mb, ladder=ladder)
        mgr = MutationManager(server, SuCoConfig())
        dur = Durability(root, DurabilityConfig(fsync="group")).attach(server, mgr)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        flushes: list[float] = []
        worker_flush = dur.worker._flush

        def timed_flush():  # the worker calls it every loop: group-commit times
            flushes.append(time.perf_counter())
            return worker_flush()

        dur.worker._flush = timed_flush
        snaps: list[dict] = []
        take_snapshot = dur.snapshot

        def timed_snapshot():  # the commit's snapshot_on_reindex calls it too
            t = time.perf_counter()
            path = take_snapshot()
            snaps.append(dict(seconds=time.perf_counter() - t, bytes=path.stat().st_size,
                              name=path.name))
            return path

        dur.snapshot = timed_snapshot
        dur.snapshot()
        executables, loaded = server.executables, _build.loaded()
        emit(dict(phase="mutable_serve", step="setup", seconds=setup_s, capacity=MUTABLE_CAPACITY,
                  fill=n / MUTABLE_CAPACITY, warmup_new_pairs=fresh, executables=executables,
                  libraries_loaded=list(loaded), baseline_snapshot=snaps[-1],
                  drift=dataclasses.asdict(mgr.check())))

        # 2. mutate while serving: 25 inserts of 4,000, one delete of 50,000 keys
        new = gaussian_mixture(MUTABLE_INSERTS * MUTABLE_INSERT_ROWS + 2 * MUTABLE_INSERT_ROWS, d,
                               seed + 4)
        insert_ms, inserted = [], []
        for i in range(MUTABLE_INSERTS):
            rows = new[i * MUTABLE_INSERT_ROWS:(i + 1) * MUTABLE_INSERT_ROWS]
            t0 = time.perf_counter()
            inserted.append(mgr.insert(rows))
            torch.cuda.synchronize()
            insert_ms.append((time.perf_counter() - t0) * 1e3)
            serve(server)
        inserted = np.concatenate(inserted)
        del_rng = np.random.default_rng(seed + 32)
        dead = np.concatenate([del_rng.choice(n, MUTABLE_DELETES // 2, replace=False),
                               del_rng.choice(inserted, MUTABLE_DELETES // 2, replace=False)])
        t0 = time.perf_counter()
        newly = mgr.delete(dead)
        torch.cuda.synchronize()
        delete_ms = (time.perf_counter() - t0) * 1e3
        dead_set = set(dead.tolist())

        def no_dead(reqs, where):
            for r in reqs:
                if dead_set & set(mgr.keys_of(r.ids).tolist()):
                    raise AssertionError(f"{where}: request {r.rid} answered a deleted key")

        no_dead(serve(server, 4), "after the delete")
        drift = mgr.check()
        emit(dict(phase="mutable_serve", step="mutate", inserts=MUTABLE_INSERTS,
                  rows_each=MUTABLE_INSERT_ROWS, insert_ms=insert_ms,
                  insert_median_ms=float(np.median(insert_ms)), delete_ms=delete_ms,
                  deleted=newly, n_live=server.engine.n_live, wal_seq=dur.wal.appended_seq,
                  drift=dataclasses.asdict(drift)))
        if newly != MUTABLE_DELETES or not any(r.startswith("fill fraction") for r in drift.reasons):
            raise AssertionError(f"mutation: {newly} deleted, drift {drift}")
        if server.executables != executables:
            raise AssertionError("mutation met a (bucket, k) pair the warm-up had not")

        # 3. the re-index prepared on the manager's stream while this thread serves
        before = serve(server, 24)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        job = mgr.reindex_async()
        t_gathered = time.perf_counter()
        trace_path = root / "burst_during_prepare.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("burst_during_prepare"):
                during = serve(server)
        prof.export_chrome_trace(str(trace_path))
        profiled_while_preparing = not job.done
        while not job.done:
            during += serve(server)
        t_done = time.perf_counter()
        engine = mgr.finish_reindex(timeout=600)
        commit_s = time.perf_counter() - t_done
        t_end = time.perf_counter()
        prepared = job._result
        gaps = [b - a for a, b in zip(flushes, flushes[1:]) if b > t_start and a < t_end]
        new_pairs = server.executables - executables
        after = serve(server, 4)
        no_dead(during + after, "around the re-index")
        loaded_after = _build.loaded()
        shares = stream_shares(trace_path, "burst_during_prepare")
        # a second successor from the same gather, on this thread's stream
        t0 = time.perf_counter()
        again = mgr._build_successor(job._gathered)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        fp_diff = fingerprint_diff(state_fingerprint(server),
                                   state_fingerprint(AnnServer(again.successor)))
        answers_equal = same(answers(engine), answers(again.successor))
        del again
        rec = dict(phase="mutable_serve", step="reindex",
                   gather_ms=job._gathered.gather_s * 1e3,
                   reindex_async_return_ms=(t_gathered - t_start) * 1e3,
                   prepare_s=prepared.prepare_s, prepare_wall_s=t_done - t_start,
                   n_live=engine.n_live, capacity=engine.capacity,
                   bursts_during=len(during) // 8, during=latencies(during),
                   before=latencies(before), after=latencies(after),
                   commit_ms=commit_s * 1e3, commit_snapshot=snaps[-1],
                   group_commit_gap_max_s=max(gaps) if gaps else None,
                   group_commit_calls=len(flushes),
                   new_pairs_after_commit=new_pairs, libraries_before=list(loaded),
                   libraries_after=list(loaded_after),
                   profiled_burst=dict(while_preparing=profiled_while_preparing, **shares),
                   second_successor=dict(seconds=sync_s, fingerprint_diff=list(fp_diff),
                                         answers_equal=answers_equal),
                   drift_after=dataclasses.asdict(mgr.check()), reindexes=mgr.reindexes)
        emit(rec)
        if (new_pairs or loaded_after != loaded or fp_diff or not answers_equal
                or snaps[-1]["name"] == snaps[0]["name"] or not profiled_while_preparing):
            raise AssertionError(f"re-index checks failed: {rec}")

        # 4. a crash at full width: two more inserts, a kill, recover on the card
        for i in range(2):
            lo = (MUTABLE_INSERTS + i) * MUTABLE_INSERT_ROWS
            mgr.insert(new[lo:lo + MUTABLE_INSERT_ROWS])
        want = state_fingerprint(server, mgr)
        want_answers = answers(server.engine)
        dur.abandon()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = recover(root, device=dev)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        rec_diff = fingerprint_diff(state_fingerprint(res.server, res.manager), want)
        rec_answers = same(answers(res.server.engine), want_answers)
        exe = res.server.executables
        serve(res.server, 4)
        rec_new_pairs = res.server.executables - exe
        res.durability.close()
        rec = dict(phase="mutable_serve", step="recover", seconds=recover_s,
                   replayed=res.report.replayed, snapshot=Path(res.report.snapshot_path).name,
                   snapshot_records=res.report.snapshot_records, warmed=res.report.warmed,
                   dropped_bytes=res.report.dropped_bytes, fingerprint_diff=list(rec_diff),
                   answers_equal=rec_answers, new_pairs=rec_new_pairs)
        emit(rec)
        if rec_diff or not rec_answers or rec_new_pairs or res.report.replayed != 2:
            raise AssertionError(f"recovery at full width failed: {rec}")
        del res, server, mgr, dur, eng, ladder, engine, prepared, job
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 5. the drill sweep at n = 65,536: every crash point, both fsync policies
    t0 = time.perf_counter()
    sub_x = data[:DRILL_N].contiguous()
    cfg = SuCoConfig()
    sub_index = build_index(sub_x, cfg)
    drill_policy = EnginePolicy(alpha=policy.alpha, beta=policy.beta, mode="fused")
    # the ladder's subspace statistics of this data, sampled once for every build
    probe = DegradationLadder(SuCoEngine(sub_x, sub_index, drill_policy, device=dev), levels=1)
    drill_stats = (probe.m_stat, probe.sigma_stat)
    del probe

    def drill_build(fsync):
        def build(droot, injector):
            engine = SuCoEngine(sub_x, sub_index, drill_policy, capacity=DRILL_N + 1024,
                                device=dev)
            lad = DegradationLadder(engine, levels=1, stats=drill_stats)
            srv = AnnServer(engine, ladder=lad)
            lad.warmup([1], [k])
            manager = MutationManager(srv, cfg)
            dur_ = Durability(droot, DurabilityConfig(fsync=fsync), crash=injector,
                              start_worker=False).attach(srv, manager)
            return srv, manager, dur_

        return build

    drills = []
    for fsync in ("group", "always"):
        for point in CRASH_POINTS:
            droot = Path(tempfile.mkdtemp(prefix="suco-drill-"))
            t1 = time.perf_counter()
            try:
                rep = recovery_drill(droot, drill_build(fsync), drill_steps(d, seed=3), point,
                                     queries=q64[:4].cpu().numpy(), k=k)
            finally:
                shutil.rmtree(droot, ignore_errors=True)
            row = dict(fsync=fsync, point=point, fired=rep.fired, acked=rep.acked,
                       applied=rep.applied, lost_acked=rep.lost_acked,
                       bit_identical=rep.bit_identical, answers_match=rep.answers_match,
                       retraces_after_warmup=rep.retraces_after_warmup,
                       quality_bounds_match=rep.quality_bounds_match,
                       dropped_bytes=rep.dropped_bytes, seconds=time.perf_counter() - t1)
            drills.append(row)
            if not (rep.fired and rep.lost_acked == 0 and rep.bit_identical and rep.answers_match
                    and rep.retraces_after_warmup == 0 and rep.quality_bounds_match):
                raise AssertionError(f"recovery drill failed: {row}, {rep.fingerprint_diff}")
    launches = kernels.launch_counts()
    emit(dict(phase="mutable_serve", step="drills", n=DRILL_N, d=d, drills=drills,
              seconds=time.perf_counter() - t0))
    emit(dict(phase="mutable_serve", step="done", seconds=time.perf_counter() - t_phase,
              launches={name: launches[name] for name in MUTABLE_SERVE_KERNELS}))
    missing = [name for name in MUTABLE_SERVE_KERNELS if launches[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the mutable_serve path: {missing}")
    return launches




def linear_attn_ops(bh: int, t: int, dk: int, dv: int, chunk: int, shift: int) -> float:
    """fp32 operations of chunked linear attention on these shapes: per
    chunk of c live tokens, an exponential, two multiplies and an add per
    (t, j, k) term of the causal part of A (j <= t - shift); two per term
    of A @ v, of the inter-chunk product and of the state update; the bonus
    (shift = 1)."""
    total = 0.0
    for c0 in range(0, t, chunk):
        c = min(chunk, t - c0)
        pairs = c * (c - 1) / 2 if shift else c * (c + 1) / 2
        total += 4 * pairs * dk + 2 * pairs * dv + 4 * c * dk * dv
        if shift:
            total += 2 * c * dk + 2 * c * dv
    return bh * total


def linear_attn_bound(nbytes_: float, bh: int, t: int, dk: int, dv: int, chunk: int,
                      shift: int, bf16: bool) -> dict:
    """Row 11's bound for its factored work (16-token sub-blocks, the
    kernel's chunking: a chunk above 128 as chunks of 128), counted from
    these shapes: the larger of the bytes over the memory rate, its 3xTF32
    products over the tensor cores' TF32 rate (2 operations a multiply-add,
    3 products each, 2 where v is a bf16 input: the off-diagonal blocks of
    A, A @ v over the causal pairs, the inter-chunk product and the state
    update), its exponentials and logarithms over the SFUs' rate (per dim
    and chunk: the diagonal blocks' terms below their main diagonal, whose
    exponent is 0, a logarithm, a q and a k factor a token, and the tabled
    factors between the sub-blocks' references: exp(r_I) and exp(lb_C -
    r_{J+1}) a block, exp(r_I - r_{J+1}) a pair, exp(lb_C)) and the diagonal
    blocks' fp32 operations (a subtract, a multiply and an add a term; the
    bonus, or the main diagonal) over 67 T/s, in ms.  ``fp32_bound_ms`` is
    the bound of the whole square on the CUDA cores
    (:func:`linear_attn_ops`)."""
    c_max = min(chunk, 128)
    mv = 2 if bf16 else 3
    tf32 = sfu = fp32 = 0.0
    for c0 in range(0, t, c_max):
        c = min(c_max, t - c0)
        blocks = [min(16, c - b) for b in range(0, c, 16)]
        nb = len(blocks)
        pairs = c * (c - 1) / 2 if shift else c * (c + 1) / 2
        diag = sum(b * (b - 1) / 2 if shift else b * (b + 1) / 2 for b in blocks)
        below = sum(b * (b - 1) / 2 for b in blocks)  # the diagonal blocks' exponentials
        tf32 += 2 * (3 * (pairs - diag) * dk + 3 * c * dk * dv + mv * c * dk * dv
                     + mv * pairs * dv)
        sfu += (below + 3 * c + 2 * nb + nb * (nb - 1) / 2 + 1) * dk
        fp32 += 3 * below * dk + (2 * c * dk + 2 * c * dv if shift else 2 * c * dk)
    terms = dict(bytes=nbytes_ / MEM_BYTES_PER_S * 1e3, tf32=bh * tf32 / TF32_OPS_PER_S * 1e3,
                 sfu=bh * sfu / SFU_OPS_PER_S * 1e3, fp32=bh * fp32 / FP32_OPS_PER_S * 1e3)
    by = max(terms, key=terms.get)
    fp32_ms, fp32_by = bound(nbytes_, linear_attn_ops(bh, t, dk, dv, chunk, shift))
    return dict(bound_ms=terms[by], bound_by="bytes" if by == "bytes" else "operations",
                bound_term=by, bound_terms_ms=terms, fp32_bound_ms=fp32_ms, fp32_bound_by=fp32_by)


def _bf16_ulp(x):
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _scan_fp64(q, k, v, w, u, shift):
    """The token-by-token recurrence in fp64: ``(o, final state)``."""
    import torch

    q, k, v, u = (a.double() for a in (q, k, v, u))
    w = w.double().clamp(1e-6, 1.0)
    s = q.new_zeros(q.shape[0], q.shape[2], v.shape[2])
    outs = []
    for i in range(q.shape[1]):
        kv = k[:, i, :, None] * v[:, i, None, :]
        if shift:
            outs.append(torch.einsum("bk,bkv->bv", q[:, i], s)
                        + (q[:, i] * u[:, 0] * k[:, i]).sum(1, keepdim=True) * v[:, i])
            s = w[:, i, :, None] * s + kv
        else:
            s = w[:, i, :, None] * s + kv
            outs.append(torch.einsum("bk,bkv->bv", q[:, i], s))
    return torch.stack(outs, 1), s


def linear_attn_inputs(g, kind: str, dtype, bh: int, t: int) -> list:
    """Row 11's inputs ``[q, k, v, w, u]`` drawn from the generator ``g`` on
    its device: ``"rwkv"`` as RWKV6's time mix makes them (64 x 64, w =
    exp(-exp(w0 + dd)), w0 = -6), ``"ssd"`` as Mamba2-SSD does (a scalar
    decay per head and token, dt-scaled values, 64 x 128, no bonus);
    ``"clip"`` and ``"mixed"`` as ``"rwkv"`` with every decay at the clip
    (1e-6), or half of them (per token and dim) at 1e-6 and half at 1."""
    import torch

    dev = g.device

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    if kind in ("rwkv", "clip", "mixed"):
        q, k, v = randn(bh, t, 64), randn(bh, t, 64), randn(bh, t, 64)
        w = torch.exp(-torch.exp(-6.0 + 0.5 * randn(bh, t, 64)))
        if kind == "clip":
            w = torch.full_like(w, 1e-6)
        elif kind == "mixed":
            w = torch.where(w < w.median(), 1.0, 1e-6)
        u = 0.1 * randn(bh, 1, 64)
    else:
        dt = torch.nn.functional.softplus(randn(bh, t, 1))
        q, k = randn(bh, t, 64), randn(bh, t, 64)
        v = randn(bh, t, 128) * dt
        w = torch.exp(-dt).expand(bh, t, 64)
        u = torch.zeros(bh, 1, 64, device=dev)
    return [a.to(dtype).contiguous() for a in (q, k, v, w, u)]


def linear_attn_padded(args: list, chunk: int) -> list:
    """Row 11's inputs ``[q, k, v, w, u]`` padded to whole chunks, as the
    reference's ops pad them (q = k = v = 0, w = 1), for the plain version."""
    import torch

    t = args[0].shape[1]
    tp = -(-t // chunk) * chunk
    return [torch.nn.functional.pad(a, (0, 0, 0, tp - t), value=1.0 if i == 3 else 0.0)
            if i < 4 else a for i, a in enumerate(args)]


def check_linear_attn(dev, seed: int, bh: int = 256, t: int = 2048) -> dict:
    """Row 11 against its plain version on the same inputs: at the RWKV6
    prefill shape (``bh`` = 8 slots x 32 heads, ``t`` tokens, 64 x 64, bf16,
    shift 1; the model's decays), at Zamba2's SSD shape (shift 0, 64 x 128,
    one decay per head and token), in fp32 at a ragged length, and at
    chunks 8, 40, 128 and 200 (16 heads, 1,000 tokens: ragged against each;
    above 128 the kernel runs sub-chunks of 128) against the plain version
    at the same chunk; with every decay at the clip, and half of them at
    the clip and half at 1, at chunks 64 and 128, both shifts (fp32).  Two
    launches at the prefill shape must give the same bits.
    Tolerance, for sums taken in another order: the state within rtol 1e-4 /
    atol 1e-4; the outputs within rtol 1e-4 (fp32) or one bf16 ulp (bf16)
    plus 1e-6 * sum |terms| -- ``mag``, the same recurrence over |q|, |k|,
    |v|, |u| -- because at these lengths an output is the small difference
    of terms in the hundreds, and either version's fp32 error there exceeds
    a fixed 1e-4.  The fp32 case also reports both versions' largest error
    against an fp64 scan of its first two heads (``fp64_witness``)."""
    import torch

    from repro_torch.kernels.linear_attn import ops as la_ops
    from repro_torch.kernels.linear_attn.ref import linear_attn_chunked

    g = torch.Generator(dev).manual_seed(seed + 20)

    def inputs(kind, dtype, bh_, t_):
        return linear_attn_inputs(g, kind, dtype, bh_, t_)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = {"rwkv6_prefill": ("rwkv", bf16, bh, t, 1, 64),
             "zamba2_ssd": ("ssd", bf16, bh, t, 0, 64),
             "fp32_ragged": ("rwkv", f32, bh, t - 48, 1, 64),
             "chunk8_fp32": ("rwkv", f32, 16, 1000, 1, 8),
             "chunk40_bf16_ssd": ("ssd", bf16, 16, 1000, 0, 40),
             "chunk128_fp32": ("rwkv", f32, 16, 1000, 1, 128),
             "chunk200_bf16": ("rwkv", bf16, 16, 1000, 1, 200)}
    # decays at the clip, where one reference point per chunk would overflow
    cases.update({f"{kind}_chunk{chunk}_shift{shift}": (kind, f32, 16, 1000, shift, chunk)
                  for kind in ("clip", "mixed") for chunk in (64, 128) for shift in (1, 0)})
    out = {}
    for name, (kind, dtype, bh_, t_, shift, chunk) in cases.items():
        args = inputs(kind, dtype, bh_, t_)
        o, st = la_ops.linear_attention_with_state(*args, chunk=chunk, shift=shift)
        if name == "rwkv6_prefill":  # two launches, the same bits
            o2, st2 = la_ops.linear_attention_with_state(*args, chunk=chunk, shift=shift)
            equal_bits = bool(torch.equal(o, o2) and torch.equal(st, st2))
            del o2, st2
            if not equal_bits:
                raise AssertionError("linear_attn: two launches gave different bits")
        if not (torch.isfinite(o).all() and torch.isfinite(st).all()):
            raise AssertionError(f"linear_attn ({name}): outputs are not finite")
        padded = linear_attn_padded(args, chunk)
        plain = lambda: linear_attn_chunked(*padded, chunk=chunk, shift=shift)  # noqa: E731
        po, ps = plain()
        po = po[:, :t_]
        mag = linear_attn_chunked(*(a if i == 3 else a.abs() for i, a in enumerate(padded)),
                                  chunk=chunk, shift=shift)[0][:, :t_].float()
        of, pf = o.float(), po.float()
        err_o = (of - pf).abs()
        if dtype == torch.float32:
            ok_o = (err_o <= 1e-4 * pf.abs() + 1e-6 * mag).all()
        else:
            ok_o = (err_o <= _bf16_ulp(torch.maximum(of.abs(), pf.abs())) + 1e-6 * mag).all()
        err_s = (st - ps).abs()
        if not (ok_o and (err_s <= 1e-4 + 1e-4 * ps.abs()).all()):
            raise AssertionError(f"linear_attn ({name}) outside its tolerance of the plain version")
        dk, dv = args[0].shape[2], args[2].shape[2]
        bnd = linear_attn_bound(nbytes(*args, o, st), bh_, t_, dk, dv, chunk, shift,
                                dtype == torch.bfloat16)
        out[name] = dict(
            shape=dict(bh=bh_, t=t_, dk=dk, dv=dv, chunk=chunk, shift=shift, dtype=str(dtype)),
            max_abs_err=float(err_o.max()), state_max_abs_err=float(err_s.max()),
            max_err_over_sum_abs_terms=float((err_o / mag.clamp_min(1e-30)).max()),
            max_abs_o=float(pf.abs().max()),
            **timed(lambda: la_ops.linear_attention_with_state(*args, chunk=chunk,
                                                                  shift=shift), 10),
            plain_ms=time_ms(plain, 2, warmup=1), **bnd)
        if dtype == torch.float32:
            o64, s64 = _scan_fp64(*(a[:2] for a in args), shift=shift)
            out[name]["fp64_witness"] = dict(
                heads=2, kernel_o=float((of[:2].double() - o64).abs().max()),
                plain_o=float((pf[:2].double() - o64).abs().max()),
                kernel_state=float((st[:2].double() - s64).abs().max()),
                plain_state=float((ps[:2].double() - s64).abs().max()))
        del o, st, po, ps, padded, args, mag
    main_case = out["rwkv6_prefill"]
    return dict(max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
                ms_clock=main_case["ms_clock"], call_ms=main_case["call_ms"], plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
                bound_by=main_case["bound_by"], library_ms=None,
                detail=dict(out, fp32_bound_ms=main_case["fp32_bound_ms"],
                            equal_bits=equal_bits, dk_limits=linear_attn_dk_limits()))


def linear_attn_dk_limits() -> dict:
    """The widest dk the card takes at each chunk tile: the largest whose
    block, at the narrowest value slice (16), fits in a block's shared
    memory, from the source's own layout (``kernel.smem_bytes``)."""
    from repro_torch.kernels.linear_attn import kernel as la_kernel

    limits = {}
    for tile in la_kernel.TILES:
        lo, hi = 0, 1 << 16  # smem_bytes(tile, lo) fits, smem_bytes(tile, hi) does not
        while hi - lo > 1:
            mid = (lo + hi) // 2
            fits = la_kernel.smem_bytes(tile, mid, 16) <= la_kernel._SMEM_LIMIT
            lo, hi = (mid, hi) if fits else (lo, mid)
        limits[tile] = lo
    return limits


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def moe_stages(p, cfg, b: int, s: int, dev, reps: int = 5) -> dict:
    """One MoE layer (``p``: a layer's ``moe`` subtree of the compute tree)
    at ``(b, s)`` on random bf16 input, each stage timed alone by CUDA
    events over ``reps`` calls: routing (router product, softmax, top-k
    sort), dispatch (the pairs' sort, slots), the buffer's gather, the
    experts' products and SwiGLU, and the combine (a gather and an add a
    step of k).  ``dispatch_share`` is the stages other than the experts'
    over their sum; ``experts_tflops`` the experts' 6 E B C D F operations
    over their time."""
    import torch

    from repro_torch.models import layers as L

    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(dev).manual_seed(0),
                    device=dev).to(torch.bfloat16)
    cap = L.moe_capacity(cfg, s)
    top_p, top_e = L.moe_route(p, x, cfg)
    token, filled, slot = L.moe_dispatch(top_e, cfg.n_experts, cap)
    h = L.moe_buffer(x, token, filled)
    out = L.moe_experts(p, h)
    ms = dict(route=time_ms(lambda: L.moe_route(p, x, cfg), reps),
              dispatch=time_ms(lambda: L.moe_dispatch(top_e, cfg.n_experts, cap), reps),
              buffer=time_ms(lambda: L.moe_buffer(x, token, filled), reps),
              experts=time_ms(lambda: L.moe_experts(p, h), reps),
              combine=time_ms(lambda: L.moe_combine(out, top_p, top_e, slot, cap), reps))
    total = sum(ms.values())
    ops = 6 * cfg.n_experts * b * cap * cfg.d_model * cfg.d_ff
    return dict(batch=b, seq=s, capacity=cap, ms=ms, layer_ms=total,
                dispatch_share=1 - ms["experts"] / total,
                experts_tflops=ops / ms["experts"] / 1e9,
                kept_pairs=int((slot < cap).sum()), pairs=slot.numel())


def lm_serve_phase(dev, seed: int, cfg, phase: str = "lm_serve", n_req: int = 16,
                   slots: int = 8, prompt_len: int = 2048, gen_len: int = 32,
                   layers_full: int | None = None) -> dict:
    """``cfg`` served through the port's ``Server``: fp32 master weights
    drawn on the card from ``seed`` and dropped once the server holds its
    compute tree, ``n_req`` requests of ``prompt_len`` random tokens in
    batches of ``slots``, ``gen_len`` greedy tokens each; then one prefill
    batch and one decode step under the profiler.  RWKV6 (``ssm``) and
    Zamba2 (``hybrid``) must launch row 11 once a layer per prefill batch
    and no other port kernel; a dense or MoE model runs no port kernel, and
    must launch none.  An MoE model's prefill of one batch, run twice, must
    give equal logits bit for bit (the combine adds in a fixed order), and
    its layer 0 is timed stage by stage (:func:`moe_stages`) at the prefill
    and decode shapes.  ``layers_full`` is the layer count of the published
    config where the caller cut it (``cfg.n_layers`` else).  Returns the
    path's launches."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import Model
    from repro_torch.models.backbone import layer_params

    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves(params))
    server = Server(model, params, slots, prompt_len + gen_len + 1)
    del params  # the fp32 master's linear weights (37 GB at Gemma2-9B)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (n_req, prompt_len))
    server.run([Request(-1, prompts[0, :64])], 2)  # first use: library, cuBLAS handles
    server.timings.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = server.run([Request(i, prompts[i]) for i in range(n_req)], gen_len)
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    batches = len(server.timings)
    want = dict.fromkeys(launches, 0)
    if cfg.family in ("ssm", "hybrid"):
        want["linear_attn"] = cfg.n_layers * batches
    if launches != want:
        raise AssertionError(f"{phase} launched {launches}, not {want} (row 11 once a layer "
                             "per prefill batch for ssm and hybrid, else no port kernel)")
    tokens = np.array([r.generated for r in done])
    if tokens.shape != (n_req, gen_len) or not (tokens < cfg.vocab_size).all():
        raise AssertionError("the server's answers are not gen_len in-vocabulary tokens each")
    decode_ms = [1e3 * x for tm in server.timings for x in tm["decode_s"]]
    toks = torch.as_tensor(prompts[:slots], device=dev)
    logits, cache = model.prefill(server.params, toks, max_seq=server.max_seq)
    if not torch.isfinite(logits[:, : cfg.vocab_size]).all():
        raise AssertionError("prefill logits are not finite")
    nxt = logits.argmax(-1)
    moe = {}
    if cfg.family == "moe":
        again = model.prefill(server.params, toks, max_seq=server.max_seq)[0]
        moe["prefill_equal_bits"] = bool(torch.equal(again, logits))
        if not moe["prefill_equal_bits"]:
            raise AssertionError("two prefills of one batch gave different logits")
        del again
        layer0 = layer_params(server.params["blocks"], 0)["moe"]
        moe["moe_stages"] = dict(prefill=moe_stages(layer0, cfg, slots, prompt_len, dev),
                                 decode=moe_stages(layer0, cfg, slots, 1, dev))
    prof = dict(prefill=profile_batch(
                    lambda: model.prefill(server.params, toks, max_seq=server.max_seq)),
                decode_step=profile_batch(
                    lambda: model.decode_step(server.params, cache, nxt, prompt_len)))
    emit(dict(phase=phase, model=cfg.name, layers=cfg.n_layers,
              layers_full=layers_full or cfg.n_layers, d_model=cfg.d_model,
              vocab=cfg.vocab_size, dtype=cfg.dtype, params=n_params, init_seconds=init_s,
              requests=n_req, slots=slots, prompt_len=prompt_len, gen_len=gen_len,
              prefill_seconds_per_batch=[tm["prefill_s"] for tm in server.timings],
              decode_ms_median=float(np.median(decode_ms)), decode_ms_p90=float(
                  np.percentile(decode_ms, 90)), decode_steps=len(decode_ms),
              run_seconds=run_s, generated_tokens_per_s=tokens.size / run_s,
              max_memory_allocated=peak, linear_attn_launches=launches["linear_attn"],
              launches=launches, profile=prof, first_tokens=tokens[:2, :8].tolist(), **moe))
    del server, cache, logits
    torch.cuda.empty_cache()
    return launches


def leaves(tree):
    """The tensors of a parameter tree, depth first."""
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def _forced(model, params, prompt, tokens):
    """Logits (n, B, V) of the prompt's last position and of each decode
    step fed ``tokens`` in turn (teacher forcing)."""
    import torch

    logits, cache = model.prefill(params, prompt, max_seq=prompt.shape[1] + tokens.shape[1])
    out = [logits.float().cpu()]
    for i in range(tokens.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, tokens[:, i], prompt.shape[1] + i)
        out.append(logits.float().cpu())
    return torch.stack(out)


def lm_cpu_recheck_phase(dev, seed: int, cfg, phase: str = "lm_cpu_recheck",
                         prompt_len: int = 64, gen_len: int = 8) -> dict:
    """``cfg`` (a few layers at a served model's full width, cut by the
    caller), one request of
    ``prompt_len`` tokens and ``gen_len`` greedy tokens on the card; the
    same weights on the CPU, fed the card's tokens.  Tolerance: the model's
    own bf16 error, ``tol`` = the largest distance of the CPU's bf16 logits
    from its fp32 logits on the same weights.  The card's logits must lie
    within ``tol`` of the CPU's, and each of the card's tokens must be the
    CPU's greedy token, or a near tie there (top two within twice the
    card-CPU distance at that step).  The ``ssm`` and ``hybrid`` models must
    launch row 11 once a layer in the card's run, the others nothing."""

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import Model

    model = Model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed + 10))
    prompt = np.random.default_rng(seed + 11).integers(0, cfg.vocab_size, (1, prompt_len))
    kernels.reset_launch_counts()
    server = Server(model, params, 1, prompt_len + gen_len + 1)
    req = server.run([Request(0, prompt[0])], gen_len)[0]
    launches = kernels.launch_counts()
    tokens = torch.tensor([req.generated])
    card = _forced(model, server.params, torch.as_tensor(prompt, device=dev), tokens.to(dev))
    t0 = time.perf_counter()
    cpu_params = _to(params, "cpu")
    del params, server
    cpu = _forced(model, model.compute_params(cpu_params), torch.as_tensor(prompt), tokens)
    f32 = Model(dataclasses.replace(cfg, dtype="float32"))
    ref32 = _forced(f32, cpu_params, torch.as_tensor(prompt), tokens)
    cpu_s = time.perf_counter() - t0
    v = cfg.vocab_size
    card, cpu, ref32 = card[..., :v], cpu[..., :v], ref32[..., :v]
    tol = float((cpu - ref32).abs().max())
    dist = (card - cpu).abs().amax(-1)  # (steps, 1)
    greedy = cpu.argmax(-1)
    want = tokens.T
    top2 = cpu.topk(2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]) <= 2 * dist
    equal = greedy == want
    emit(dict(phase=phase, model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, vocab=v,
              prompt_len=prompt_len, gen_len=gen_len, seconds_cpu=cpu_s,
              linear_attn_launches=launches["linear_attn"], card_tokens=req.generated,
              cpu_greedy_tokens=greedy[:, 0].tolist(), tokens_equal=int(equal.sum()),
              near_ties=int((~equal & near_tie).sum()), max_abs_logit_diff=float(dist.max()),
              tolerance_bf16_vs_fp32=tol, logit_scale=float(cpu.abs().max())))
    want_launches = dict.fromkeys(launches, 0)
    if cfg.family in ("ssm", "hybrid"):
        want_launches["linear_attn"] = cfg.n_layers
    if launches != want_launches or not torch.isfinite(card).all():
        raise AssertionError(f"the {cfg.n_layers}-layer card run launched {launches}, not "
                             f"{want_launches}, or its logits are not finite")
    if not (float(dist.max()) <= tol and (equal | near_tie).all()):
        raise AssertionError("the card's logits or greedy tokens disagree with the CPU's")
    return dict(tokens_equal=int(equal.sum()), steps=gen_len)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and queries")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA card")
    import numpy as np

    from repro_torch import EnginePolicy, SuCoConfig, SuCoEngine, kernels
    from repro_torch.configs import get_config
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
    profiles = {m: profile_batch(lambda m=m: engine.query(q64[:m], k)) for m in (1, 64)}
    emit(dict(phase="profile", **{str(m): p_ for m, p_ in profiles.items()}))

    # 4. the dense and streaming query modes over the same index
    launches_by_path = dict(main_path=launches)
    launches_by_path["query_modes"] = query_modes_phase(data, engine.index, q64, answers, k)

    # 5. SC-Linear (Algorithm 1) over the same data
    launches_by_path["sc_linear"] = sc_linear_phase(data, x_np, q_np, q64, gt, cfg.n_subspaces, k)

    # 6. the K-means library: PQ codebooks and IVF coarse assignment
    launches_by_path["kmeans_library"], library_checks = kmeans_library_phase(data, args.seed)

    # 7. the index lifecycle: minibatch build, live mutation, save and load
    launches_by_path["lifecycle"] = lifecycle_phase(data, q64, gt, engine.index, policy,
                                                    args.seed, k)

    # 8. the ANN serving layer over the main path's engine: a degradation
    # ladder, the sync and pipelined servers, overload and autoscale
    launches_by_path["ann_serve"] = ann_serve_phase(x_np, q64, gt, engine, args.seed, k)

    # 9. the durable mutable serving stack over the main path's index: live
    # mutation, a re-index prepared on a stream of its own, a crash and recovery
    launches_by_path["mutable_serve"] = mutable_serve_phase(x_np, data, q64, engine.index,
                                                            policy, args.seed, k)

    # 10. the LM stack: RWKV6-1.6B served at full width, then a 2-layer model of
    # the same width on the card and again on the CPU
    lm_cfg = get_config("rwkv6-1.6b")
    launches_by_path["lm_serve"] = lm_serve_phase(dev, args.seed, lm_cfg)
    lm_cpu_recheck_phase(dev, args.seed, dataclasses.replace(lm_cfg, n_layers=2))

    # 11. each kernel against its plain version at its path's shapes
    both, c0 = build_stats_inputs(data, engine.index.spec, cfg)
    checks = check_kernels(dev, data, both, c0, engine, q64, cfg, k, args.seed)
    del both
    checks.update(check_query_kernels(dev, data, engine.index, q64, cfg, engine.tiles_for(64, k),
                                      args.seed))
    checks.update(library_checks)
    checks["linear_attn"] = check_linear_attn(dev, args.seed)
    emit(dict(phase="kernel_checks", **{name: rec for name, rec in checks.items()}))

    # 12. the same 8 queries on the CPU: plain versions over the same index
    t0 = time.perf_counter()
    cpu_policy = EnginePolicy(alpha=0.05, beta=0.02, tiles=engine.tiles_for(8, k))
    cpu_engine = SuCoEngine(x_np, engine.index.to("cpu"), cpu_policy, device="cpu")
    cpu_res = cpu_engine.query(torch.from_numpy(q_np[:8]), k)
    card_res = engine.query(q64[:8], k)
    emit(dict(phase="cpu_recheck", seconds=time.perf_counter() - t0,
              **same_answers(card_res, cpu_res)))

    # 13. the hybrid LM family: Zamba2-1.2B served at full width (row 11 in SSD
    # mode, once a Mamba2 layer per prefill batch), then 3 layers of that
    # width at period 2 (one unit, the shared block, a tail layer) on the card
    # and again on the CPU
    del cpu_engine, cpu_res, card_res
    hybrid_cfg = get_config("zamba2-1.2b")
    launches_by_path["lm_serve_hybrid"] = lm_serve_phase(dev, args.seed, hybrid_cfg,
                                                         phase="lm_serve_hybrid")
    lm_cpu_recheck_phase(dev, args.seed,
                         dataclasses.replace(hybrid_cfg, n_layers=3, hybrid_period=2),
                         phase="lm_cpu_recheck_hybrid")
    ssd = checks["linear_attn"]["detail"]["zamba2_ssd"]
    checks["linear_attn (ssd)"] = dict(ssd, library_ms=None, detail=dict(
        shape=ssd["shape"], fp32_bound_ms=ssd["fp32_bound_ms"],
        launches=launches_by_path["lm_serve_hybrid"]["linear_attn"]))

    # 14. the moe LM family: OLMoE-1B-7B served at full width (two prefills of
    # one batch equal bit for bit), Mixtral-8x7B at full width on 6 of its 32
    # layers (all 32 hold 93.4 GB in bf16); then 2 layers of each width on the
    # card and again on the CPU, Mixtral's at reduced_config's window of 32, which
    # a 64-token prompt passes (the 4,096 window masks nothing at 2,081 positions)
    moe_cfg = get_config("olmoe-1b-7b")
    launches_by_path["lm_serve_moe"] = lm_serve_phase(dev, args.seed, moe_cfg,
                                                      phase="lm_serve_moe")
    mixtral_cfg = get_config("mixtral-8x7b")
    launches_by_path["lm_serve_mixtral"] = lm_serve_phase(
        dev, args.seed, dataclasses.replace(mixtral_cfg, n_layers=MIXTRAL_LAYERS),
        phase="lm_serve_mixtral", layers_full=mixtral_cfg.n_layers)
    lm_cpu_recheck_phase(dev, args.seed, dataclasses.replace(moe_cfg, n_layers=2),
                         phase="lm_cpu_recheck_moe")
    lm_cpu_recheck_phase(dev, args.seed,
                         dataclasses.replace(mixtral_cfg, n_layers=2, sliding_window=32),
                         phase="lm_cpu_recheck_mixtral")

    # 15. the dense LM family: Gemma2-9B served at full width, then a 2-layer
    # Gemma2 of that width (layer 0 local at reduced_config's window of 32,
    # layer 1 global) on the card and again on the CPU.  Last, after every
    # kernel is timed: traces taken after it lose their kernels far more often
    dense_cfg = get_config("gemma2-9b")
    launches_by_path["lm_serve_dense"] = lm_serve_phase(dev, args.seed, dense_cfg,
                                                        phase="lm_serve_dense")
    lm_cpu_recheck_phase(dev, args.seed,
                         dataclasses.replace(dense_cfg, n_layers=2, local_window=32),
                         phase="lm_cpu_recheck_dense")

    rows = []
    for name, (src, replaces) in SOURCES.items():
        rec_ = checks[name]
        path = PATH_OF.get(name)
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches_by_path[path][name] if path else 0,
                         path=path,
                         launches_by_path={p_: c[name] for p_, c in launches_by_path.items()},
                         max_abs_err=rec_["max_abs_err"],
                         ms=rec_["ms"], ms_clock=rec_.get("ms_clock"),
                         call_ms=rec_["call_ms"], plain_ms=rec_["plain_ms"],
                         bound_ms=rec_["bound_ms"], bound_by=rec_["bound_by"],
                         library_ms=rec_["library_ms"]))
        extras = ("fp32_bound_ms", "tf32_bound_ms", "rechecks_per_point",
                  "rechecks_per_pair", "screen_err_over_margin", "max_screen_err_over_margin",
                  "equal_bits", "instantiations", "fingerprint",
                  "parent_fingerprint", "q", "tile", "bitmap_route", "smem_bytes", "l2_route",
                  "in_path")
        rows[-1].update({key: rec_["detail"][key] for key in extras
                         if key in rec_.get("detail", {})})
        if name == "sc_score_cells_prefilter_compact":  # its time in the profiled batches
            for m, p_ in profiles.items():
                rows[-1]["in_path"][str(m)]["profile"] = compact_in_profile(p_)
        # rows 3-5 at the IVF shapes ("wide"), row 3 at PQ8x8's ("pq"), row 7
        # over all n columns ("dense"), row 11 at Zamba2's SSD shape ("ssd")
        for variant in ("wide", "pq", "dense", "ssd"):
            other = checks.get(f"{name} ({variant})")
            if other is None:
                continue
            rows[-1][variant] = {key: other[key] for key in (
                "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
            rows[-1][variant]["ms_clock"] = other.get("ms_clock")
            rows[-1][variant].update({key: other["detail"][key]
                                      for key in (*extras, "launches", "shape")
                                      if key in other.get("detail", {})})
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
