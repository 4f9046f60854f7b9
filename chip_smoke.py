#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (``--seed S`` picks
the data).  It builds the CUDA kernels from ``src/repro_torch/csrc``, then
drives nineteen paths, each with every kernel's launch count set to 0 just
before it and read just after.  Nine run over SIFT1M's shape (n =
1,000,000, d = 128, data from ``gaussian_mixture``):

* ``main_path``: build a SuCo index with the default ``SuCoConfig`` and serve
  batches of 1, 8 and 64 queries through ``SuCoEngine`` (fused mode);
  Then ``static_gate`` (no path of its own): each built kernel's registers,
  static shared memory, stack and spills from ``cuobjdump -res-usage``,
  registers x threads within the card's 65,536 and static plus dynamic
  shared memory within its opt-in limit at the main path's launches; those
  launches as ``kernels/_plans.py`` plans them equal to the ones a profiled
  run makes (kernels, grids, threads, shared memory, registers);
  ``static_device_limits("h100")`` equal to the card's properties; the
  sources' shared-memory sizes equal to their Python copies
  (``kernels/_plans.py``); the fused batches of 1, 8 and 64 under the sort
  and the counting merge in turns, bit for bit equal; and, where the parent
  commit's tree is unpacked at ``build/parent``, the same batches on it and
  on this tree in turns (``tools/time_fused.py``);
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
* ``sharded_serve``: the sharded engine (``repro_torch.distributed``) at
  world size 1 over NCCL on a (1, 1) mesh: config A (Ns = 16, sqrt_k = 64,
  the reference's production dry-run) as a ``ShardedEnginePool`` at k = 50
  and 10, config B (the main path's ``SuCoConfig``) at k = 10, each built
  from the data and served batches of 1, 8, 64 and 256 through
  ``query_resilient`` (none degraded, no host sync, no step added after the
  warm-up); config B's recall@10 must reach 0.85, the reference's sharded
  floor.  Rows 3 and 4 run in its builds, rows 7 and 2 in its queries, and
  each is held to its plain version at this path's shapes.
* ``baselines``: the five competitor baselines (``repro_torch.baselines``)
  at fig9_12's data and parameters (20,000 x 64; HNSW-lite at 5,000, on the
  host), on the card and on the CPU, ids equal but at ties and boundary
  cases; IVF-Flat, E2LSH and IMI-PQ with their class defaults at 1M.
* ``dryrun_suco``: rank 0's share of the sharded 1B x 128 dry-run at pod1
  (``repro_torch.launch.dryrun_suco``), for real: 62,500,000 x 8 fp32 points
  (one subspace) seeded on the card, a (1, 1) mesh at world size 1 over
  NCCL, ``build_sharded`` (rows 3, 4), a batch of 8 and one of 256 at k = 50
  (rows 7, 2), then rows 3, 4, 7 and 2 at the phase's own shapes against
  their plain versions; ``max_memory_allocated`` over the run must lie
  within 10% of the fake run's prediction for the same program
  (``dryrun_suco --share``, in a process of its own with no card visible,
  run after the last timed phase so that it shares the host with no
  timing, beside the LM dry-run's ``--share`` of the ``lm_sharded`` cell;
  the comparisons are the ``dryrun_suco_prediction`` and
  ``lm_sharded_prediction`` records).

The eighth, ``lm_serve``, serves RWKV6-1.6B (``get_config("rwkv6-1.6b")``, 24
layers, d_model 2,048, vocab 65,536, bf16 compute, fp32 master weights drawn
on the card from the seed) through ``repro_torch.launch.serve.Server``: 16
requests of 2,048-token prompts, 8 slots, 32 greedy tokens each.
``lm_cpu_recheck`` then runs a 2-layer model of the same width on the card
and, with the same weights and the card's tokens, on the CPU.

Then, after the kernel checks and the SuCo CPU re-check below, training.
``lm_train`` trains RWKV6-1.6B at full width, nothing cut,
through ``repro_torch.launch.train``'s own functions: 10 AdamW steps of 8 x
2,048 ``SyntheticLM`` tokens, bf16 compute, fp32 master and optimizer state,
remat on, peak lr 3e-4; row 11 runs in every layer's forward and again in the remat
recompute (48 launches a step), its backward the plain version recomputed
under autograd.  It reports the step seconds, tokens/s, the losses, the peak
memory, a profiled step and the forward, backward and optimizer step timed
alone, and fails unless the loss is finite and falls.
``lm_sharded`` then trains the same model through the sharded step
(``make_train_step(mesh=...)``, DTensor) on a (1, 1, 1) ``DeviceMesh``
over NCCL at world size 1: 3 AdamW steps of the same 8 x 2,048 tokens from
the same seed, then the same through the unsharded step.  It reports
whether the losses and params are bit-equal (else the largest differences,
held to ``lm_train_recheck``'s tolerances, and the first differing op of a
one-layer forward), the median step seconds both ways, a profiled sharded
step's idle share, row 11's launches a step (48) and the peak memory,
which ``lm_sharded_prediction`` sets beside the fake dry-run of the same
cell at the end and holds within 10% of it.
``lm_train_recheck`` runs RWKV6 and granite-3-2b at full width on 2 layers
in fp32 on the card and on the CPU from the same weights and batch (loss,
every gradient leaf, the parameters after one AdamW step), and holds row
11's ``autograd.Function`` to autograd of its plain version on the card.
``sc_attention`` runs SC-attention (``repro_torch.core.sc_attention``) over
the ``long_500k`` context (524,288 keys, 32 heads of 128, fp32; the
drifting keys of ``examples/long_context_sc_attention.py``) at n_keep 512,
2,048 and 8,192 against exact attention, and a reduced case on the card and
the CPU.

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

Then the cross-attention families, after ``lm_cpu_recheck_mixtral``.
``lm_serve_vlm`` serves Llama-3.2-Vision-11B (``get_config(
"llama-3.2-vision-11b")`` unchanged: 40 layers, 32 dense and 8 blocks of
tanh-gated cross-attention, one after every 4 dense layers; d_model 4,096,
32 / 8 heads of 128, SwiGLU d_ff 14,336, vocab 128,256, RoPE theta 5e5)
with ``lm_serve``'s traffic, each request with the 1,601 all-zero patch
embeddings the server gives it; ``lm_serve_audio`` serves Whisper-large-v3
(``get_config("whisper-large-v3")`` unchanged: 32 encoder layers over 1,500
frames and 32 decoder layers, d_model 1,280, 20 heads of 64, GELU d_ff
5,120, LayerNorm, learned positions, vocab 51,866) with 16 requests of
224-token prompts (inside its decoder's published 448-token context), 8
slots, 32 greedy tokens.  Both drop the fp32 master once the server holds
its bf16 tree, launch no port kernel, run their profiled prefill batch and
decode step on seeded N(0, 1) ``extras``, and report the cross K / V
cache's bytes, a cross-attention, a cross block, a dense layer or the
encoder timed alone, and the cross-attention's share of a prefill batch.
``lm_cpu_recheck_vlm`` (2 layers at period 2: one dense layer and one cross
block over all 1,601 patches, the gates at seeded values in [0.5, 1.0]) and
``lm_cpu_recheck_audio`` (2 encoder and 2 decoder layers over all 1,500
frames) run on the card and on the CPU over seeded ``extras``, the card's
tokens drawn through ``prefill`` / ``decode_step``, held as
``lm_cpu_recheck``.

The last, ``lm_serve_dense``, runs last, after the kernel checks and the
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
#: the other main paths whose launches a kernel's ``launches`` adds (row 11
#: runs in the served prefill and in the trainer's forward and recompute)
ALSO_ON = {"linear_attn": ("lm_train", "lm_sharded")}
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
    missing = [name for name, p in PATH_OF.items()
               if (p == path or path in ALSO_ON.get(name, ())) and counts[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


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
    if most < 1:  # every trace lost every kernel: nothing read the device's clock
        warnings.warn("device_ms: no trace showed a kernel; timed by CUDA events instead")
        return dict(ms=time_ms(fn, reps), readings=[], events_per_call=0, events_lost=None,
                    retakes=retakes, clock="cuda_events")
    for i in range(n):
        while sum(k for _, _, k in traces[i]) < most:
            if retakes == RETAKES:
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

    # gather_rerank: a compaction buffer of candidates per query; and the
    # baselines' width, d = 64: brute_force's call over fig9_12's 20,000
    # points (int64 ids, an expanded arange)
    ids = torch.randint(0, n, (m, cap), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(1))
    out["gather_rerank"] = rerank_record(ids, data, q64, "main")
    g64 = torch.Generator(dev).manual_seed(seed + 64)
    x64 = torch.randn((20_000, 64), device=dev, generator=g64)
    q30 = torch.randn((30, 64), device=dev, generator=g64)
    # all pairs: one library call computes the same distances
    out["gather_rerank (d64)"] = rerank_record(
        torch.arange(x64.shape[0], device=dev).expand(q30.shape[0], -1), x64, q30, "d64",
        library=("torch.cdist(donot_use_mm_for_euclid_dist) ** 2",
                 lambda: torch.cdist(q30, x64, compute_mode="donot_use_mm_for_euclid_dist") ** 2))
    return out


def span_bytes(t) -> int:
    """The bytes a tensor's elements span in its storage: an expanded view
    (stride 0) counts its stored elements once."""
    return (1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))) * t.element_size()


def rerank_bound(ids, x, q, out) -> tuple[float, str, int]:
    """Row 2's ``(bound_ms, bound_by, distinct rows)``: the ids as stored,
    the queries and the output once, and each distinct row the ids name
    (clipped as the kernel clips them) once from device memory; a row named
    again adds no bytes (it may come from L2), and each candidate's 3 d
    flops."""
    n, d = x.shape
    distinct = int(ids.clamp(0, n - 1).unique().numel())
    bms, by = bound(span_bytes(ids) + nbytes(q, out) + distinct * d * 4,
                    3.0 * ids.numel() * d)
    return bms, by, distinct


def rerank_record(ids, x, q, tag: str, probe: bool = False, library=None) -> dict:
    """Row 2 at one shape: held to its plain version (rtol 2e-5: both sum
    the same squares in another order) and to a second launch (equal bits),
    timed, and its bound (:func:`rerank_bound`); ``library``, ``(name,
    fn)``, is one PyTorch call that computes the same distances, where
    there is one (timed only).
    With ``probe``, the card's rate for scattered 32-byte reads over ``x``
    at as many reads as candidates (``kernel.scattered_read_probe``,
    ``csrc/read_probe.cu``: the best of 1, 2, 4 and 8 reads a thread in
    flight) and the time the distinct rows the ids name take at that rate:
    what the scattered rows alone take."""
    import torch

    from repro_torch.kernels.gather_rerank import kernel as gk
    from repro_torch.kernels.gather_rerank import ops as gather_ops
    from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref

    got = gather_ops.gather_rerank_block(ids, x, q)
    want = gather_rerank_block_ref(ids, x, q)
    err = (got - want).abs()
    if not (err <= 2e-5 * want.abs()).all():
        raise AssertionError(f"gather_rerank ({tag}) outside rtol 2e-5 of the plain version")
    if not torch.equal(got, gather_ops.gather_rerank_block(ids, x, q)):
        raise AssertionError(f"gather_rerank ({tag}): two launches differ")
    (m, c), d = ids.shape, x.shape[1]
    bms, by, distinct = rerank_bound(ids, x, q, got)
    v = gk.vec(d, x.data_ptr(), q.data_ptr())
    g, k, _ = gk.plan(d, v)
    detail = dict(shape=[m, c, d], ids=str(ids.dtype).removeprefix("torch."), equal_bits=True,
                  group=g, vec=v, per_thread=k, distinct_rows=distinct)
    if library is not None:
        detail["library"] = library[0]
    if probe:
        ms = {r: device_ms(lambda r=r: gk.scattered_read_probe(x, m * c, r), 50)["ms"]
              for r in (1, 2, 4, 8)}
        rate = m * c * 32 / min(ms.values()) / 1e6
        detail["scattered_read"] = dict(reads=m * c, ms_by_reads_a_thread=ms, gb_per_s=rate,
                                        distinct_rows_ms_at_rate=distinct * d * 4 / rate / 1e6)
    return dict(max_abs_err=float(err.max()),
                **timed(lambda: gather_ops.gather_rerank_block(ids, x, q), 50),
                plain_ms=time_ms(lambda: gather_rerank_block_ref(ids, x, q), 20),
                bound_ms=bms, bound_by=by,
                library_ms=None if library is None else time_ms(library[1], 20),
                detail=detail)


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


def profile_batch(fn, host_events: bool = True) -> dict:
    """One call of ``fn`` (a served batch) under ``torch.profiler``: wall
    time, the device's busy time (the device events' own time summed;
    operator events, whose device time repeats their kernels', are left out)
    and idle share, the kernels taking the most device time, and the port's
    own kernels with their time and launches.  ``host_events=False`` traces
    the device alone (a train step's ~10^5 host operator events take the
    profiler minutes to gather)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # the same batch once untraced
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_events else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
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


def stats_errors(name: str, x, got, want, centroids=None, chain: int | None = None,
                 report: dict | None = None) -> float:
    """Hold a statistics kernel's output against its plain version's:
    assignments and counts equal, sums within 1e-5 * sum |terms| (fp32 sums
    in another order), inertia within 1e-5 relative.  Returns the largest
    absolute error of the sums.

    With ``chain`` (the longest run of fp32 additions behind one sum: a
    block's points and then the blocks) and ``centroids``, the sums and
    inertia are held instead to their fp64 values over the shared
    assignments, as a fraction of their terms' magnitudes: the kernel's
    within the probabilistic bound of fp32 summation (Higham and Mary,
    2019), 7 sqrt(chain) 2^-24, and the plain version's (a running fp32
    total over the blocks, whose rounding errors need not cancel) within
    the worst case, gamma_chain = chain 2^-24 / (1 - chain 2^-24).
    ``report`` gets each one's largest error over that magnitude.  Past
    some millions of points the two can part by more than 1e-5 of the
    terms."""
    import math

    import torch

    a, sums, counts, inertia = got
    b, _, s = x.shape
    k = sums.shape[1]
    if not (torch.equal(a, want[0]) and torch.equal(counts, want[2])):
        raise AssertionError(f"{name}: assignments or counts differ from the plain version")
    rows = (a.long() + torch.arange(b, device=x.device)[:, None] * k).reshape(-1)
    mag = torch.zeros((b * k, s), dtype=torch.float64, device=x.device)
    mag.index_add_(0, rows, x.abs().double().reshape(-1, s))
    mag = mag.reshape(b, k, s)
    err = (sums.double() - want[1].double()).abs()
    if chain is None:
        if not (err <= 1e-5 * mag).all():
            raise AssertionError(f"{name}: sums outside 1e-5 * sum |terms|")
        if not ((inertia.double() - want[3].double()).abs() <= 1e-5 * want[3].double()).all():
            raise AssertionError(f"{name}: inertia outside 1e-5 relative")
        return float(err.max())
    u = 2.0**-24
    tols = dict(kernel=7 * math.sqrt(chain) * u, plain=chain * u / (1 - chain * u))
    exact = torch.zeros((b * k, s), dtype=torch.float64, device=x.device)
    exact.index_add_(0, rows, x.double().reshape(-1, s))
    exact = exact.reshape(b, k, s)
    c64 = centroids.double()
    exact_in = torch.stack([((x[i].double() - c64[i][a[i].long()]) ** 2).sum() for i in range(b)])
    for who, (sm, inert) in (("kernel", (sums, inertia)), ("plain", want[1::2])):
        tol = tols[who]
        if report is not None:
            report[who] = dict(
                sums=float(((sm.double() - exact).abs() / mag.clamp_min(1e-300)).max()),
                inertia=float(((inert.double() - exact_in).abs() / exact_in).max()), bound=tol)
        if not ((sm.double() - exact).abs() <= tol * mag).all():
            raise AssertionError(f"{name}: the {who} version's sums outside {tol:.3g} * "
                                 "sum |terms| of their fp64 values")
        if not ((inert.double() - exact_in).abs() <= tol * exact_in).all():
            raise AssertionError(f"{name}: the {who} version's inertia outside {tol:.3g} "
                                 "relative of its fp64 value")
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




#: the kernels the sharded engine runs: Lloyd statistics and the paired
#: assignment in its build, chunk scores and the candidate rerank in its query
SHARDED_KERNELS = ("kmeans_stats", "kmeans_pair_assign_hist", "sc_score_cells", "gather_rerank")
SHARDED_BATCHES = (1, 8, 64, 256)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def first_call(mod, name: str, fn) -> tuple:
    """Run ``fn()`` with ``mod.<name>`` wrapped to keep a copy of its first
    call's arguments; returns them."""
    import torch

    orig, got = getattr(mod, name), []

    def rec(*args, **kw):
        if not got:
            got.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return orig(*args, **kw)

    setattr(mod, name, rec)
    try:
        fn()
    finally:
        setattr(mod, name, orig)
    return got[0]


def sync_warnings(fn) -> int:
    """The synchronising calls torch's sync debug mode reports in ``fn()``."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def sharded_kernel_checks(cfg, index, data, q, query, tag: str = "sharded",
                          lloyd_plain: tuple[int, int] | None = (2, 1),
                          fp64_sums: bool = False) -> dict:
    """Rows 2, 3, 4 and 7 against their plain versions at a sharded path's
    shapes: the build's (2 Ns, n, h1) half-subspace points with its final
    centroids (rows 3 and 4), and the arguments one query chunk of
    ``cfg.q_chunk`` queries (``query(q[:q_chunk])``) gave the chunk scores
    (row 7, one block of the shard) and the rerank (row 2, the chunk's
    pool).  Integers must be equal, the Lloyd sums within 1e-5 of their
    terms and the distances within rtol 2e-5; with ``fp64_sums``, the Lloyd
    sums of each are held instead to their fp64 values (:func:`stats_errors`'
    ``chain``).  Rows 3 and 4's plain versions are timed over ``lloyd_plain``
    = (runs, warm-up runs) by CUDA events, or, where it is None, by the one
    call that checks each (host clock, synchronised at both ends).  The
    records are named ``<row> (tag)``."""
    import torch

    from repro_torch.distributed import engine as eng_mod
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
    from repro_torch.kernels.kmeans_assign.ref import kmeans_pair_assign_hist_ref, kmeans_stats_ref
    from repro_torch.kernels.sc_score import ops as score_ops
    from repro_torch.kernels.sc_score.ref import sc_score_cells_ref

    ns, s = cfg.n_subspaces, data.shape[1] // cfg.n_subspaces
    a, b, _ = eng_mod._split_local(data, ns, s)
    cb = torch.cat([a, b]).contiguous()
    c = torch.cat([index.centroids1, index.centroids2]).contiguous()
    del a, b
    bsz, n, h = cb.shape
    k, bn = c.shape[1], cfg.build_block_n
    out = {}

    def plain(fn) -> tuple:
        if lloyd_plain is not None:
            return fn(), time_ms(fn, *lloyd_plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    # the narrow route (a point in registers, the codebook in shared memory)
    # takes the path's h1-dim half-subspaces
    smem = kmeans_kernel.stats_smem_bytes(k, h)
    if kmeans_ops._stats_wide(h, smem):
        raise AssertionError(f"kmeans_stats takes the wide route at h1 = {h}, k = {k}")
    got = kmeans_ops.kmeans_stats(cb, c, block_n=bn, with_assign=True)
    chain = bn + -(-n // bn) if fp64_sums else None
    fp64 = {}
    want, plain_ms = plain(lambda: kmeans_stats_ref(cb, c, block_n=bn))
    err = stats_errors(f"kmeans_stats ({tag})", cb, got, want, centroids=c, chain=chain,
                       report=fp64)
    del want
    same_bits(f"kmeans_stats ({tag})", got,
              kmeans_ops.kmeans_stats(cb, c, block_n=bn, with_assign=True))
    bms, by = bound(nbytes(cb, c, *got[1:]), 3.0 * bsz * n * k * h)
    del got
    out[f"kmeans_stats ({tag})"] = dict(
        max_abs_err=err, **timed(lambda: kmeans_ops.kmeans_stats(cb, c, block_n=bn), 10),
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=[bsz, n, h], k=k, block_n=bn, equal_bits=True, variant="narrow",
                    smem_bytes=smem, fp64_chain=chain, fp64_errors=fp64))

    got = kmeans_ops.kmeans_pair_assign_hist(cb, c, block_n=bn)
    want, plain_ms = plain(lambda: kmeans_pair_assign_hist_ref(cb, c, block_n=bn))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kmeans_pair_assign_hist ({tag}) differs from the plain version")
    del want
    if not torch.equal(got[0][: bsz // 2] * k + got[0][bsz // 2:], index.cell_ids):
        raise AssertionError(f"the {tag} build's cell ids are not its final assignment's")
    bms, by = bound(nbytes(cb, c, *got), 2.0 * bsz * n * k * h)
    out[f"kmeans_pair_assign_hist ({tag})"] = dict(
        max_abs_err=0.0,
        **timed(lambda: kmeans_ops.kmeans_pair_assign_hist(cb, c, block_n=bn), 10),
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=[bsz, n, h], k=k, block_n=bn))
    del cb, got

    qc = q[: cfg.q_chunk]
    ranks, cuts, cells = first_call(eng_mod, "sc_scores_cells", lambda: query(qc))
    ids, x_loc, q_blk = first_call(eng_mod, "gather_rerank_block", lambda: query(qc))
    got = score_ops.sc_scores_cells(ranks, cuts, cells)
    if not torch.equal(got, sc_score_cells_ref(ranks, cuts, cells)):
        raise AssertionError(f"sc_score_cells ({tag}) differs from the plain version")
    m, bc = got.shape
    bms, by = bound(nbytes(ranks, cuts, cells, got), 2.0 * ranks.shape[0] * m * bc)
    out[f"sc_score_cells ({tag})"] = dict(
        max_abs_err=0.0, **timed(lambda: score_ops.sc_scores_cells(ranks, cuts, cells), 50),
        plain_ms=time_ms(lambda: sc_score_cells_ref(ranks, cuts, cells), 10),
        bound_ms=bms, bound_by=by, library_ms=None,
        detail=dict(shape=[ranks.shape[0], m, ranks.shape[2]], block=bc))

    out[f"gather_rerank ({tag})"] = rerank_record(ids, x_loc, q_blk, tag,
                                                  probe=x_loc.shape[1] == 8)
    return out


def sharded_serve_phase(x_np, data, q64, gt, fused_recall: float, seed: int) -> tuple[dict, dict]:
    """The sharded engine (``repro_torch.distributed``) at world size 1 over
    NCCL on a (1, 1) (data, model) mesh, over the main path's data.  Config A
    (the reference's production dry-run, ``launch/dryrun_suco.py``: Ns = 16,
    sqrt_k = 64, 10 Lloyd steps, alpha 0.03, beta 0.003) as a pool at k = 50
    and 10; config B (the main path's ``SuCoConfig``: Ns = 8, sqrt_k = 50,
    20 steps, alpha 0.05, beta 0.02) at k = 10, its recall@10 at least 0.85
    (the reference's sharded floor) beside the fused engine's.  Batches of
    1, 8, 64 and 256 through ``query_resilient``: no answer may be degraded,
    and no step may be added after the warm-up.  Then rows 2, 3, 4 and 7 at
    this path's shapes against their plain versions.  Returns (the path's
    launches, the kernel records)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.data import make_queries, recall
    from repro_torch.distributed import DistSuCoConfig, Mesh, ShardedEnginePool, ShardedSuCoEngine
    from repro_torch.distributed.engine import resolved_query_block_n

    dev = data.device
    n, d = data.shape
    q256 = torch.from_numpy(make_queries(x_np, 256, seed=seed + 2)).to(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", dev.index or 0))
    try:
        mesh = Mesh((1, 1), ("data", "model"))
        cfg_a = DistSuCoConfig()
        cfg_b = DistSuCoConfig(n_subspaces=8, sqrt_k=50, kmeans_iters=20, alpha=0.05,
                               beta=0.02, k=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pool = ShardedEnginePool.build(mesh, cfg_a, data, ks=(50, 10), device=dev)
        torch.cuda.synchronize()
        build_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng_b = ShardedSuCoEngine.build(mesh, cfg_b, data, device=dev)
        torch.cuda.synchronize()
        build_b = time.perf_counter() - t0
        warm = pool.warmup(SHARDED_BATCHES) + eng_b.warmup(SHARDED_BATCHES)
        steps0 = pool.compile_count + eng_b.compile_count
        serve_a, serve_b = {}, {}
        for m in SHARDED_BATCHES:
            for k in (50, 10):
                infos = []

                def run(m=m, k=k, infos=infos):
                    ids, dists, info = pool.query_resilient(q256[:m], k)
                    infos.append(info)
                    return ids, dists

                lat, (ids, _) = serve_times(run)
                if any(i["degraded"] for i in infos) or ids.shape != (m, k):
                    raise AssertionError(f"config A at m = {m}, k = {k}: {infos[-1]}")
                serve_a[f"{m}_k{k}"] = dict(latency_ms=lat, median_ms=float(np.median(lat)),
                                            host_syncs_per_batch=sync_warnings(run))
            lat, (ids, _) = serve_times(lambda m=m: eng_b.query(q256[:m]))
            serve_b[str(m)] = dict(latency_ms=lat, median_ms=float(np.median(lat)),
                                   host_syncs_per_batch=sync_warnings(lambda m=m: eng_b.query(q256[:m])))
        rec_b = recall(eng_b.query(q64)[0].cpu().numpy(), gt)
        rec_a = recall(pool.query(q64, 10)[0].cpu().numpy(), gt)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = pool.compile_count + eng_b.compile_count
        profiles = {str(m): profile_batch(lambda m=m: pool.query(q256[:m], 50))
                    for m in (64, 256)}
        emit(dict(phase="sharded_serve", world_size=1, mesh=mesh.shape, backend="nccl",
                  config_a=dataclasses.asdict(cfg_a), config_b=dataclasses.asdict(cfg_b),
                  block_n_a=resolved_query_block_n(mesh, cfg_a, n, d, device=dev),
                  block_n_b=resolved_query_block_n(mesh, cfg_b, n, d, device=dev),
                  build_seconds_a=build_a, build_seconds_b=build_b, warmup_steps=warm,
                  steps_after_serving=steps, serve_a=serve_a, serve_b=serve_b,
                  recall_at_10_a=rec_a, recall_at_10_b=rec_b, recall_at_10_fused=fused_recall,
                  launches={name: launches[name] for name in SHARDED_KERNELS},
                  max_memory_allocated=peak, profile_config_a_k50=profiles))
        if steps != steps0:
            raise AssertionError(f"the sharded engines added query steps after warm-up: "
                                 f"{steps0} -> {steps}")
        if rec_b < 0.85:
            raise AssertionError(f"sharded recall@10 {rec_b} below the 0.85 floor")
        if any(r["host_syncs_per_batch"] for r in (*serve_a.values(), *serve_b.values())):
            raise AssertionError("a sharded batch synchronised with the host")
        missing = [name for name in SHARDED_KERNELS if launches[name] < 1]
        if missing:
            raise AssertionError(f"kernels never launched on the sharded_serve path: {missing}")
        checks = sharded_kernel_checks(pool.cfg, pool.index, data, q256,
                                       lambda qc: pool.query(qc, pool.cfg.k))
        for name in SHARDED_KERNELS:
            checks[f"{name} (sharded)"]["detail"]["launches"] = launches[name]
        del pool, eng_b
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, checks


# ---- static_gate: the kernels' real resource use, the H100 table, the merges ----

#: where ``static_gate`` looks for the parent tree to time the fused batches
#: against (``git archive`` of the parent commit unpacked there); absent in a
#: plain checkout, and then the phase says so
PARENT_TREE = ROOT / "build" / "parent"
FUSED_BATCHES = (1, 8, 64)


def res_usage(lib: Path) -> list[dict]:
    """``cuobjdump -res-usage`` of a built library: per kernel function its
    registers, static shared memory, stack and local (spill) bytes."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, name = [], None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and name:
            reg, stack, shared, local = map(int, m.groups())
            out.append(dict(function=name, registers=reg, stack=stack, static_smem=shared,
                            local=local))
            name = None
    return out


def kernel_of(function: str) -> str | None:
    """The kernel of a (mangled) function name, as ``_plans.THREADS`` names it."""
    from repro_torch.kernels import _plans

    hits = [k for k in _plans.THREADS if k in function]
    return max(hits, key=len) if hits else None


def main_path_launches(engine, data, q64, cfg, k: int) -> tuple[list, list]:
    """The launches of the main path's kernels, planned and made: the fused
    batch of 64 (rows 1 and 2) and one pass each of the build's Lloyd
    statistics and paired assignment at its shapes (rows 3 and 4), run once
    under ``torch.profiler`` and an op trace.  Returns the plans
    (``_plans.launches`` of the traced operators' arguments) and the kernels
    the card launched: each port kernel's name, grid, block, shared memory
    and registers as the profiler's chrome trace gives them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.trace_rules import OpTrace
    from repro_torch.core.tuning import autotune_build_block_n, device_limits, static_device_limits
    from repro_torch.kernels import _plans
    from repro_torch.kernels.kmeans_assign import ops as kmeans_ops

    limits = static_device_limits("h100")
    n, d = engine.x.shape
    block_n = cfg.block_n or autotune_build_block_n(
        n, d, sqrt_k=cfg.sqrt_k, n_subspaces=cfg.n_subspaces, limits=device_limits(engine.x.device))
    both, c0 = build_stats_inputs(data, engine.index.spec, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, OpTrace() as tr:
        engine._padded_query(q64, k)  # counts nothing on the engine
        kmeans_ops.kmeans_stats(both, c0, block_n=block_n)
        kmeans_ops.kmeans_pair_assign_hist(both, c0, block_n=block_n)
        torch.cuda.synchronize()
    del both, c0
    path = ROOT / "build" / "static_gate_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    made = []
    for ev in json.loads(path.read_text())["traceEvents"]:
        kern = kernel_of(ev.get("name", "")) if ev.get("cat") == "kernel" else None
        if kern is not None:
            a = ev.get("args", {})
            made.append(dict(kernel=kern, grid=a.get("grid"), block=a.get("block"),
                             smem=a.get("shared memory"), registers=a.get("registers per thread")))
    # the occupancy a one-wave launcher reads, at the registers it launched with
    registers = {m["kernel"]: m["registers"] for m in made}
    planned = [ln for e in tr.kernel_ops()
               for ln in _plans.launches(e.name, e.args, limits, registers)]
    path.unlink()
    return planned, made


def launch_mismatches(planned: list, made: list, usage: dict) -> list[str]:
    """Where the card's launches (:func:`main_path_launches`) part from the
    plans and the libraries' resource use (``usage``: per library the
    :func:`res_usage` records, with ``kernel``): a kernel, grid or block the
    plans do not have, or the reverse (a plan's block is ``_plans.THREADS``',
    so this holds that table to the launches); shared memory other than one
    of the kernel's static sizes plus the planned dynamic bytes
    (``cuobjdump`` counts the block's 1 KB reserve in a kernel that uses it,
    every one here but row 2's, and the profiler never does); or registers
    no instantiation of the kernel has."""
    from collections import Counter

    from repro_torch.kernels import _plans

    want = Counter((ln.kernel, tuple(ln.grid), (ln.threads, 1, 1)) for ln in planned)
    got = Counter((m["kernel"], tuple(m["grid"] or ()), tuple(m["block"] or ())) for m in made)
    out = [f"planned, not launched: {key} x{c}" for key, c in (want - got).items()]
    out += [f"launched, not planned: {key} x{c}" for key, c in (got - want).items()]
    statics, regs = {}, {}
    for fs in usage.values():
        for f in fs:
            statics.setdefault(f["kernel"], set()).add(f["static_smem"])
            regs.setdefault(f["kernel"], set()).add(f["registers"])
    dyn = {(ln.kernel, tuple(ln.grid)): ln.smem_bytes for ln in planned}
    for m in made:
        kern = m["kernel"]
        plan = dyn.get((kern, tuple(m["grid"] or ())))
        static = {st - r for st in statics.get(kern, ())
                  for r in (0, _plans.RESERVED_SMEM_BYTES) if st >= r}
        if plan is not None and m["smem"] - plan not in static:
            out.append(f"{kern} grid {m['grid']}: {m['smem']} B of shared memory, planned "
                       f"{plan} + static {sorted(statics.get(kern, ()))}")
        if m["registers"] not in regs.get(kern, ()):
            out.append(f"{kern}: {m['registers']} registers a thread, cuobjdump "
                       f"{sorted(regs.get(kern, ()))}")
    return out


def smem_mirrors(cfg, k_cells: int) -> dict:
    """The Python copies of the sources' shared-memory sizes
    (``kernels/_plans.py``) against the built libraries' own functions, at
    the main path's, PQ8x8's and the IVF shapes: they must agree."""
    import ctypes

    from repro_torch.kernels import _build, _plans

    _I = ctypes.c_int
    checks = {}
    for q in (1, 2, 4, 8, 16):
        for ns in (1, cfg.n_subspaces, 16):
            got = _build.entry("sc_score", "sc_score_smem_bytes", [_I, _I, _I])(ns, k_cells, q)
            checks[f"sweep ns={ns} K={k_cells} q={q}"] = (got, _plans.sweep_smem_bytes(ns, k_cells, q))
    for fn, mirror in (("kmeans_stats_smem_bytes", _plans.stats_smem_bytes),
                       ("kmeans_pair_smem_bytes", _plans.pair_smem_bytes),
                       ("kmeans_assign_narrow_smem_bytes", _plans.narrow_smem_bytes)):
        c_fn = _build.entry("kmeans_assign", fn, [_I, _I])
        for kk, s in ((cfg.sqrt_k, 8), (64, 4), (256, 16), (50, 16), (1024, 64), (32, 3)):
            checks[f"{fn} k={kk} s={s}"] = (c_fn(kk, s), mirror(kk, s))
    bad = {key: v for key, v in checks.items() if v[0] != v[1]}
    return dict(checked=len(checks), disagree=bad)


def fused_merge_times(data, index, q64, k: int, rounds: int = 7) -> dict:
    """The main path's fused batches of 1 / 8 / 64 under ``merge_impl="sort"``
    and ``"counting"`` on one engine's data, timed in turns (host clock,
    each batch ending in a synchronise; median of ``rounds``); their answers
    must be equal bit for bit."""
    import numpy as np
    import torch

    from repro_torch import EnginePolicy, SuCoEngine

    engines = {impl: SuCoEngine(data, index, EnginePolicy(alpha=0.05, beta=0.02, merge_impl=impl),
                                device=data.device) for impl in ("sort", "counting")}
    for eng in engines.values():
        eng.warmup(batch_sizes=FUSED_BATCHES, ks=(k,))
    out = {}
    for m in FUSED_BATCHES:
        lat = {impl: [] for impl in engines}
        res = {}
        for _ in range(rounds):
            for impl, eng in engines.items():
                t, res[impl] = serve_times(lambda eng=eng: eng.query(q64[:m], k), reps=1)
                lat[impl] += t
        for name, a, b in zip(("ids", "dists", "scores"), res["sort"], res["counting"]):
            if not torch.equal(a, b):
                raise AssertionError(f"m = {m}: the sort and counting merges differ in {name}")
        out[str(m)] = {impl: dict(median_ms=float(np.median(v)), latency_ms=v)
                       for impl, v in lat.items()}
        out[str(m)]["equal_bits"] = True
    return out


def parent_vs_change(rounds: int = 10) -> dict:
    """The fused batches of 1 / 8 / 64 on :data:`PARENT_TREE` and on this
    tree, in ``rounds`` pairs of turns (parent, change, change, parent, ...),
    each a process of ``tools/time_fused.py``; absent a parent tree, says
    so."""
    if not (PARENT_TREE / "src" / "repro_torch").is_dir():
        return dict(status=f"no parent tree at {PARENT_TREE.relative_to(ROOT)}")
    runs = []
    order = [("parent", PARENT_TREE / "src"), ("change", ROOT / "src")]
    for r in range(rounds):
        for label, src in (order if r % 2 == 0 else order[::-1]):
            proc = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "time_fused.py"), "--src", str(src),
                 "--label", label], capture_output=True, text=True, timeout=600, check=True)
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return dict(status="ok", runs=runs)


def static_gate_phase(engine, data, q64, cfg, k: int) -> dict:
    """The static gate on the card: each built kernel's real resource use
    (``cuobjdump -res-usage``) held to the H100 at the main path's launches,
    those launches as planned (``kernels/_plans.py``) held to the ones the
    card makes,
    ``static_device_limits("h100")`` held to the card's properties, the
    sources' shared-memory sizes held to their Python copies, the fused
    batches under the sort and the counting merge, and (with a parent tree
    at ``build/parent``) the fused batches on the parent's tree and this
    one in turns."""
    import torch

    from repro_torch.core.tuning import static_device_limits
    from repro_torch.kernels import _build, _plans

    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(engine.x.device)
    lim = static_device_limits("h100")
    card = dict(fast_bytes=props.L2_cache_size, hbm_bytes=props.total_memory,
                smem_optin_bytes=props.shared_memory_per_block_optin,
                n_sm=props.multi_processor_count, regs_per_sm=props.regs_per_multiprocessor,
                max_threads_per_block=props.max_threads_per_block,
                smem_per_sm_bytes=props.shared_memory_per_multiprocessor,
                max_threads_per_sm=props.max_threads_per_multi_processor)
    table = {key: dict(static=getattr(lim, key), card=v) for key, v in card.items()}
    usage, breaches = {}, []
    for name in _build.SOURCES:
        for f in res_usage(_build.library_path(name)):
            kern = kernel_of(f["function"])
            threads = _plans.THREADS.get(kern)
            f.update(kernel=kern, threads=threads)
            if threads is None:
                breaches.append(f"{name}: no thread count for {f['function']}")
            elif f["registers"] * threads > card["regs_per_sm"]:
                breaches.append(f"{kern}: {f['registers']} registers x {threads} threads > "
                                f"{card['regs_per_sm']}")
            usage.setdefault(name, []).append(f)
    static_smem = {}
    for fs in usage.values():
        for f in fs:
            static_smem[f["kernel"]] = max(static_smem.get(f["kernel"], 0), f["static_smem"])
    launches, made = main_path_launches(engine, data, q64[:64], cfg, k)
    mismatches = launch_mismatches(launches, made, usage)
    for ln in launches:
        total = static_smem.get(ln.kernel, 0) + ln.smem_bytes
        if total > card["smem_optin_bytes"]:
            breaches.append(f"{ln.kernel}: {total} B of shared memory > "
                            f"{card['smem_optin_bytes']}")
        if ln.threads > card["max_threads_per_block"]:
            breaches.append(f"{ln.kernel}: {ln.threads} threads")
    mirrors = smem_mirrors(cfg, cfg.sqrt_k ** 2)
    merges = fused_merge_times(data, engine.index, q64, k)
    ab = parent_vs_change()
    smem_at = {}
    for ln in launches:
        smem_at[ln.kernel] = max(smem_at.get(ln.kernel, 0), ln.smem_bytes)
    runs = ab.get("runs", [])
    rec = dict(phase="static_gate", limits=table,
               limits_equal=all(v["static"] == v["card"] for v in table.values()),
               # [kernel, registers, static smem, stack, local (spill) bytes, threads]
               res_usage={name: [[f["kernel"], f["registers"], f["static_smem"], f["stack"],
                                  f["local"], f["threads"]] for f in fs]
                          for name, fs in usage.items()},
               main_path_dynamic_smem=smem_at, main_path_launches=len(launches),
               launches_made=len(made), launch_mismatches=mismatches,
               smem_mirrors=mirrors, breaches=breaches,
               fused_merge_ms={m: {impl: r[impl]["median_ms"] for impl in ("sort", "counting")}
                               for m, r in merges.items()},
               parent_vs_change=dict(
                   status=ab["status"],
                   runs=[dict(label=r_["label"], build_seconds=r_["build_seconds"],
                              median_ms={m: v["median_ms"] for m, v in r_["batches"].items()})
                         for r_ in runs],
                   same_answers=len({json.dumps(r_["fingerprint"]) for r_ in runs}) <= 1),
               nvidia_smi=smi_line(), seconds=time.perf_counter() - t0)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "static_gate.json").write_text(json.dumps(dict(
        rec, res_usage_full=usage, main_path_launches=[ln._asdict() for ln in launches],
        launches_made=made,
        fused_merge=merges, parent_vs_change=ab), indent=1))
    emit(rec)
    if not rec["limits_equal"]:
        raise AssertionError(f"static_device_limits('h100') differs from the card: {table}")
    if breaches:
        raise AssertionError(f"resource breaches: {breaches}")
    if mirrors["disagree"]:
        raise AssertionError(f"shared-memory copies disagree: {mirrors['disagree']}")
    if mismatches or not made:
        raise AssertionError(f"the plans part from the card's launches: "
                             f"{mismatches or 'none made'}")
    return rec


# ---- dryrun_suco: rank 0's share of the 1B x 128 dry-run, for real ------------

DRYRUN_KERNELS = ("kmeans_stats", "kmeans_pair_assign_hist", "sc_score_cells", "gather_rerank")
DRYRUN_SHARE = ROOT / "build" / "dryrun" / "share.json"


def dryrun_suco_phase(seed: int) -> tuple[dict, dict, dict]:
    """Rank 0's share of the 1B x 128 dry-run cell at pod1, run for real: 62.5M
    x 8 fp32 points (one subspace) seeded on the card, on a (1, 1) mesh at
    world size 1 over NCCL, ``build_sharded`` (rows 3, 4), a warm-up batch of 8
    and a batch of 256 at k = 50 (rows 7, 2).  Then rows 3, 4, 7 and 2 at the
    phase's own shapes against their plain versions (:func:`sharded_kernel_checks`,
    records ``<row> (dryrun)``).  Returns (the path's launches, the kernel
    records, the run's figures for :func:`dryrun_prediction_phase`)."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.distributed import Mesh, ShardedSuCoEngine, build_sharded
    from repro_torch.distributed.engine import resolved_query_block_n
    from repro_torch.launch.dryrun_suco import SHARE_N, suco_config

    dev = torch.device("cuda")
    cfg = suco_config(n_subspaces=1)
    d = 8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", dev.index or 0))
    try:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((SHARE_N, d), device=dev, generator=g)
        q = torch.randn((256, d), device=dev, generator=g)
        mesh = Mesh((1, 1), ("data", "model"))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        index = build_sharded(mesh, x, cfg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches_build = kernels.launch_counts()
        eng = ShardedSuCoEngine(mesh, cfg, x, index, device=dev)
        t0 = time.perf_counter()
        eng.query(q[:8])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids, dists = eng.query(q)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        ok_out = (tuple(ids.shape) == (256, cfg.k) and bool(torch.isfinite(dists).all())
                  and int(ids.min()) >= 0 and int(ids.max()) < SHARE_N)
        block_n = resolved_query_block_n(mesh, cfg, SHARE_N, d, device=dev)
        del ids, dists
        checks = sharded_kernel_checks(cfg, eng.index, x, q, eng.query, tag="dryrun",
                                       lloyd_plain=None, fp64_sums=True)
        for name in DRYRUN_KERNELS:
            checks[f"{name} (dryrun)"]["detail"]["launches"] = launches[name]
        del eng, index, x
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    run = dict(n=SHARE_N, d=d, n_subspaces=1, world_size=1, backend="nccl",
               query_block_n=block_n, build_seconds=build_s, warmup_batch8_seconds=warm_s,
               batch256_seconds=batch_s, max_memory_allocated=peak,
               launches_build={name: launches_build[name] for name in DRYRUN_KERNELS},
               launches={name: launches[name] for name in DRYRUN_KERNELS},
               answers_ok=ok_out, nvidia_smi=smi_line())
    emit(dict(phase="dryrun_suco", **run))
    missing = [name for name in DRYRUN_KERNELS if launches[name] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the dryrun_suco path: {missing}")
    if not ok_out:
        raise AssertionError("the share's batch of 256 gave malformed answers")
    return launches, checks, run


def dryrun_prediction_phase(run: dict, lm_run: dict) -> None:
    """The fake runs of two programs, after the last timed phase, in
    processes of their own started together: ``dryrun_suco``'s share
    (``python -m repro_torch.launch.dryrun_suco --share``, no card visible),
    whose prediction the card's ``max_memory_allocated`` over that program
    (``run``, from :func:`dryrun_suco_phase`) must lie within 10% of; and
    the ``lm_sharded`` cell (``python -m repro_torch.launch.dryrun --share``:
    RWKV6-1.6B, 8 x 2,048, a (1, 1, 1) mesh over a fake group, ``meta``
    shares), whose predicted peak the card's over the sharded steps
    (``lm_run``, from :func:`lm_sharded_phase`) must lie within 10% of."""
    import os

    for path in (DRYRUN_SHARE, LM_SHARE):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = {
        "suco": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun_suco", "--share", "--output",
             str(DRYRUN_SHARE)], cwd=ROOT, env=dict(env, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
        "lm": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--share", "--out",
             str(LM_SHARE.parent)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
    }
    errs = {}
    try:
        for name, proc in procs.items():
            errs[name] = proc.communicate(timeout=900)[1]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"the fake {name} share run failed: {errs[name][-2000:]}")
    seconds = time.perf_counter() - t0
    pred = json.loads(DRYRUN_SHARE.read_text())
    peak = run["max_memory_allocated"]
    rel = abs(peak - pred["peak_bytes"]) / pred["peak_bytes"]
    emit(dict(phase="dryrun_suco_prediction", max_memory_allocated=peak,
              predicted_peak_bytes=pred["peak_bytes"],
              predicted_build_peak_bytes=pred["build_peak_bytes"], relative_error=rel,
              query_block_n=run["query_block_n"], fake_query_block_n=pred["query_block_n"],
              fake_kernel_calls=pred["cost_analysis"]["kernel_calls"],
              fake_run_seconds=pred["run_s"], seconds=seconds))
    lm = json.loads(LM_SHARE.read_text())
    lm_peak = lm["memory_analysis"]["peak_bytes"]
    lm_rel = abs(lm_run["max_memory_allocated"] - lm_peak) / lm_peak
    emit(dict(phase="lm_sharded_prediction", max_memory_allocated=lm_run["max_memory_allocated"],
              predicted_peak_bytes=lm_peak, relative_error=lm_rel,
              predicted_argument_bytes=lm["memory_analysis"]["argument_size_in_bytes"],
              predicted_output_bytes=lm["memory_analysis"]["output_size_in_bytes"],
              fake_flops=lm["cost_analysis"]["flops"],
              fake_kernel_calls=lm["cost_analysis"]["kernel_calls"],
              fake_collectives=lm["collectives"], fake_run_seconds=lm["run_s"],
              seconds=seconds, nvidia_smi=smi_line()))
    if lm["status"] != "ok":
        raise AssertionError(f"the fake lm_sharded cell: {lm}")
    if lm_rel > 0.10:
        raise AssertionError(f"lm_sharded's max_memory_allocated {lm_run['max_memory_allocated']} "
                             f"lies {lm_rel:.1%} from the prediction {lm_peak}")
    if rel > 0.10:
        raise AssertionError(f"max_memory_allocated {peak} lies {rel:.1%} from the prediction "
                             f"{pred['peak_bytes']}")
    if pred["query_block_n"] != run["query_block_n"]:
        raise AssertionError(f"query_block_n {run['query_block_n']} on the card, "
                             f"{pred['query_block_n']} in the fake run")


#: fig9_12's competitors at its own parameters (``benchmarks/fig9_12_competitors.py``):
#: name -> (class name, constructor kwargs, query kwargs); HNSW-lite at n = 5,000
BASELINES = {
    "lsh": ("E2LSH", dict(n_tables=8, n_bits=10), dict(threshold=1)),
    "ivf": ("IVFFlat", dict(n_cells=128, iters=5), dict(nprobe=8)),
    "imi_pq": ("IMIPQ", dict(sqrt_k=32, iters=5), dict(n_candidates=400)),
    "hnsw": ("HNSWLite", dict(m=12, ef_construction=48), dict(ef_search=64)),
    "rpforest": ("RPForest", dict(n_trees=10, leaf_size=64), dict()),
}
BASELINES_N, BASELINES_D, BASELINES_M, HNSW_N = 20_000, 64, 30, 5_000


def tie_split(x_np, q_np, got, want, rel: float = 1e-5) -> dict:
    """Two answers' ids: equal, swapped at an exact-distance tie (fp64, within
    ``rel``), or otherwise different."""
    import numpy as np

    def d(ids):
        return ((x_np[ids].astype(np.float64) - q_np.astype(np.float64)[:, None]) ** 2).sum(-1)

    diff = got != want
    dg, dw = d(got), d(want)
    tied = np.abs(dg - dw) <= rel * np.maximum(dg, dw)
    return dict(ids_equal=int((~diff).sum()), tie_swaps=int((diff & tied).sum()),
                other=int((diff & ~tied).sum()), total=int(got.size))


def baselines_phase(x_np, data, q64, gt, seed: int) -> dict:
    """The five competitor baselines (``repro_torch.baselines``) at fig9_12's
    data and parameters (``gaussian_mixture`` 20,000 x 64, 30 queries,
    k = 10; HNSW-lite, whose walk stays on the host, at 5,000), built and
    queried on the card and again on the CPU; the card's ids must equal the
    CPU's but at distance ties and at most 1% boundary cases (an fp32 value
    within a few ulp of its threshold: an argmin, a hash floor, a median
    split).  Then IVF-Flat, E2LSH and IMI-PQ with their class defaults on the
    main path's 1M x 128 data (64 queries), on the card only: their CPU
    builds at that size take minutes.  Returns the path's launches."""
    import numpy as np
    import torch

    from repro_torch import baselines as B
    from repro_torch import kernels
    from repro_torch.data import make_dataset, recall

    dev = data.device
    rows = {}
    kernels.reset_launch_counts()
    for name, (cls_name, ctor, qkw) in BASELINES.items():
        ds = make_dataset("gaussian_mixture", HNSW_N if name == "hnsw" else BASELINES_N,
                          BASELINES_D, m=BASELINES_M, k=10, seed=seed)
        cls = getattr(B, cls_name)
        runs = {}
        for where in (("host",) if name == "hnsw" else ("cuda", "cpu")):
            kw = {} if where == "host" else dict(device=dev if where == "cuda" else "cpu")
            t0 = time.perf_counter()
            idx = cls(**ctor, **kw).build(ds.x)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            lat, ids = serve_times(lambda: idx.query(ds.queries, 10, **qkw), reps=3)
            ids = ids.cpu().numpy()
            runs[where] = dict(build_seconds=build_s, query_ms=lat,
                               median_ms=float(np.median(lat)), recall_at_10=recall(ids, ds.gt_ids),
                               memory_bytes=idx.memory_bytes(), ids=ids)
        rec = {w: {k_: v for k_, v in r.items() if k_ != "ids"} for w, r in runs.items()}
        if "cpu" in runs:
            rec["card_vs_cpu"] = tie_split(ds.x, ds.queries, runs["cuda"]["ids"],
                                           runs["cpu"]["ids"])
            if rec["card_vs_cpu"]["other"] > 0.01 * rec["card_vs_cpu"]["total"]:
                raise AssertionError(f"{name}: card and CPU ids differ past the boundary cases: "
                                     f"{rec['card_vs_cpu']}")
        rows[name] = dict(n=ds.x.shape[0], d=BASELINES_D, queries=BASELINES_M, **ctor, **qkw,
                          **rec)
    launches_small = kernels.launch_counts()
    full = {}
    for cls_name in ("IVFFlat", "E2LSH", "IMIPQ"):
        t0 = time.perf_counter()
        idx = getattr(B, cls_name)(device=dev).build(data)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        lat, ids = serve_times(lambda: idx.query(q64, 10), reps=3)
        full[cls_name] = dict(build_seconds=build_s, query_ms=lat, median_ms=float(np.median(lat)),
                              recall_at_10=recall(ids.cpu().numpy(), gt),
                              memory_bytes=idx.memory_bytes())
        del idx
    launches = kernels.launch_counts()
    emit(dict(phase="baselines", fig9_12=rows, n_1m=dict(n=data.shape[0], d=data.shape[1],
                                                         queries=q64.shape[0], **full),
              launches_fig9_12=launches_small, launches=launches))
    torch.cuda.empty_cache()
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


def seeded_extras(cfg, b: int, seed: int, dev):
    """``b`` rows of seeded N(0, 1) bf16 ``extras`` on ``dev`` for the
    ``audio`` (``encoder_seq`` frames) and ``vlm`` (``vision_tokens``
    patches) families, as the reference's tests draw them; ``None`` for
    the others."""
    import torch

    from repro_torch.models.backbone import memory_tokens

    n = memory_tokens(cfg)
    if n is None:
        return None
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn((b, n, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)


def cross_stages(params, cfg, b: int, s: int, extras, dev, reps: int = 5) -> dict:
    """The cross-attention families' parts at the prefill shape ``(b, s)``
    on random bf16 input, each timed alone by CUDA events over ``reps``
    calls: one cross-attention (its pre-norm, the memory's K / V
    projections, Q, the attention over the memory, the output projection);
    ``vlm``: a whole cross block (the gate and its MLP too) and one dense
    layer; ``audio``: the encoder over ``extras``."""
    import torch

    from repro_torch.models import backbone as B
    from repro_torch.models import layers as L
    from repro_torch.models.prefill import _cross_attn_with_kv, _dense_block_prefill

    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    if cfg.family == "vlm":
        c, p0 = B.layer_params(params["cross_blocks"], 0), B.layer_params(params["blocks"], 0)

        def attn():
            return _cross_attn_with_kv(c["cross"], L.apply_norm(c["ln1"], x, cfg), extras, cfg)

        ms = dict(cross_attn=time_ms(attn, reps),
                  cross_block=time_ms(lambda: B.gated(c, x, attn()[0], cfg), reps),
                  self_layer=time_ms(lambda: _dense_block_prefill(p0, x, cfg, None), reps))
        n_cross = cfg.n_layers // cfg.cross_attn_period
    else:
        enc = B.encode(cfg, params, extras)
        p0 = B.layer_params(params["blocks"], 0)
        ms = dict(encoder=time_ms(lambda: B.encode(cfg, params, extras), reps),
                  cross_attn=time_ms(lambda: _cross_attn_with_kv(
                      p0["cross"], L.apply_norm(p0["ln_x"], x, cfg), enc, cfg), reps))
        n_cross = cfg.n_layers
    return dict(batch=b, seq=s, memory=extras.shape[1], n_cross=n_cross, ms=ms)


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
    and decode shapes.  An ``audio`` or ``vlm`` model is served the
    server's zero ``extras`` and launches no port kernel; its profiled
    prefill batch and decode step run on seeded N(0, 1) ``extras``
    (:func:`seeded_extras`), and it reports its cross K / V cache's bytes,
    its parts timed alone (:func:`cross_stages`) and the cross-attention's
    share of a served prefill batch.  ``layers_full`` is the layer count of
    the published config where the caller cut it (``cfg.n_layers`` else).
    Returns the path's launches."""
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
    extras = seeded_extras(cfg, slots, seed + 3, dev)
    logits, cache = model.prefill(server.params, toks, extras=extras, max_seq=server.max_seq)
    if not torch.isfinite(logits[:, : cfg.vocab_size]).all():
        raise AssertionError("prefill logits are not finite")
    nxt = logits.argmax(-1)
    moe = {}
    if extras is not None:
        stages = cross_stages(server.params, cfg, slots, prompt_len, extras, dev)
        prefill_ms = 1e3 * float(np.median([tm["prefill_s"] for tm in server.timings]))
        moe.update(memory_tokens=extras.shape[1], cross_stages=stages,
                   cross_kv_bytes=sum(cache[n].numel() * cache[n].element_size()
                                      for n in ("xk", "xv")),
                   cross_attn_share_of_prefill=stages["n_cross"] * stages["ms"]["cross_attn"]
                   / prefill_ms)
        if cfg.family == "audio":
            moe["encoder_share_of_prefill"] = stages["ms"]["encoder"] / prefill_ms
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
                    lambda: model.prefill(server.params, toks, extras=extras,
                                          max_seq=server.max_seq)),
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


def _forced(model, params, prompt, tokens, extras=None):
    """Logits (n, B, V) of the prompt's last position and of each decode
    step fed ``tokens`` in turn (teacher forcing)."""
    import torch

    logits, cache = model.prefill(params, prompt, extras=extras,
                                  max_seq=prompt.shape[1] + tokens.shape[1])
    out = [logits.float().cpu()]
    for i in range(tokens.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, tokens[:, i], prompt.shape[1] + i)
        out.append(logits.float().cpu())
    return torch.stack(out)


def _greedy(model, params, prompt, extras, gen_len: int) -> list[int]:
    """``gen_len`` greedy tokens of one request through ``model.prefill`` /
    ``decode_step`` with ``extras``, as the server draws them."""
    logits, cache = model.prefill(params, prompt, extras=extras,
                                  max_seq=prompt.shape[1] + gen_len + 1)
    out = [int(logits.argmax(-1)[0])]
    for t in range(gen_len - 1):
        nxt = logits.argmax(-1)
        logits, cache = model.decode_step(params, cache, nxt, prompt.shape[1] + t)
        out.append(int(logits.argmax(-1)[0]))
    return out


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
    launch row 11 once a layer in the card's run, the others nothing.  An
    ``audio`` or ``vlm`` model gets seeded ``extras`` (:func:`seeded_extras`,
    drawn on the CPU) on both devices, a ``vlm`` model's gates are set to
    seeded values in [0.5, 1.0] on both trees, and the card's tokens come
    from ``model.prefill`` / ``decode_step`` (the server's zero ``extras``
    would make a VLM's cross-attention add exactly 0)."""

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import Model

    model = Model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed + 10))
    prompt = np.random.default_rng(seed + 11).integers(0, cfg.vocab_size, (1, prompt_len))
    extras = seeded_extras(cfg, 1, seed + 12, "cpu")
    cross = {}
    if cfg.family == "vlm":
        gate = params["cross_blocks"]["gate"]
        gate.copy_(0.5 + 0.5 * torch.rand(gate.shape, generator=torch.Generator().manual_seed(
            seed + 13)))
        cross["gates"] = gate.flatten().tolist()
    if extras is not None:
        cross["memory_tokens"] = extras.shape[1]
    ex_dev = None if extras is None else extras.to(dev)
    compute = model.compute_params(params)
    kernels.reset_launch_counts()
    if extras is None:
        generated = Server(model, compute, 1, prompt_len + gen_len + 1).run(
            [Request(0, prompt[0])], gen_len)[0].generated
    else:
        generated = _greedy(model, compute, torch.as_tensor(prompt, device=dev), ex_dev,
                            gen_len)
    launches = kernels.launch_counts()
    tokens = torch.tensor([generated])
    card = _forced(model, compute, torch.as_tensor(prompt, device=dev), tokens.to(dev), ex_dev)
    t0 = time.perf_counter()
    cpu_params = _to(params, "cpu")
    del params, compute
    cpu = _forced(model, model.compute_params(cpu_params), torch.as_tensor(prompt), tokens,
                  extras)
    f32 = Model(dataclasses.replace(cfg, dtype="float32"))
    ref32 = _forced(f32, cpu_params, torch.as_tensor(prompt), tokens, extras)
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
              linear_attn_launches=launches["linear_attn"], card_tokens=generated,
              cpu_greedy_tokens=greedy[:, 0].tolist(), tokens_equal=int(equal.sum()),
              near_ties=int((~equal & near_tie).sum()), max_abs_logit_diff=float(dist.max()),
              tolerance_bf16_vs_fp32=tol, logit_scale=float(cpu.abs().max()), **cross))
    want_launches = dict.fromkeys(launches, 0)
    if cfg.family in ("ssm", "hybrid"):
        want_launches["linear_attn"] = cfg.n_layers
    if launches != want_launches or not torch.isfinite(card).all():
        raise AssertionError(f"the {cfg.n_layers}-layer card run launched {launches}, not "
                             f"{want_launches}, or its logits are not finite")
    if not (float(dist.max()) <= tol and (equal | near_tie).all()):
        raise AssertionError("the card's logits or greedy tokens disagree with the CPU's")
    return dict(tokens_equal=int(equal.sum()), steps=gen_len)


# -------------------------------- training ----------------------------------


def train_args(**kw):
    """``repro_torch.launch.train``'s arguments (its parser's defaults) with
    ``kw`` replaced."""
    from repro_torch.launch.train import parser

    args = parser().parse_args([])
    for key, val in kw.items():
        setattr(args, key, val)
    return args


def lm_train_phase(dev, seed: int, steps: int = 10, global_batch: int = 8,
                   seq_len: int = 2048, arch: str = "rwkv6-1.6b", full: bool = True,
                   lr: float = 3e-4) -> dict:
    """RWKV6-1.6B trained at full width through ``repro_torch.launch.train``'s
    own functions (``build``, ``init_state``, ``batch_on``, the train step):
    ``steps`` AdamW steps of ``global_batch`` x ``seq_len`` tokens of
    ``SyntheticLM``, bf16 compute, fp32 master and state, remat on, the
    launcher's schedule at peak ``lr`` (3e-4: at the launcher's default of
    1e-3, sized for the reduced configs, the full-width loss wanders, see
    PERF.md); each step's ``float(loss)`` is the host read the launcher
    also makes.
    Reports the median step seconds and tokens/s, the first and last loss,
    the peak memory, one profiled step (busy / idle share, the top device
    time), the forward, the forward and backward (row 11's backward is its
    plain version), and the optimizer step each timed alone by CUDA events,
    row 11's backward alone at one layer's shape, and row 11's launches a
    step.  Fails if the loss is not finite or does not fall, or row 11's
    counter does not move by two launches a layer a step (the forward and
    the remat recompute).  Returns the path's launches."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.launch import train as T
    from repro_torch.train.optimizer import apply_gradients
    from repro_torch.train.train_step import loss_and_grads

    args = train_args(arch=arch, reduced=not full, steps=steps, global_batch=global_batch,
                      seq_len=seq_len, seed=seed, device=str(dev), lr=lr)
    t0 = time.perf_counter()
    cfg, model, step_fn, data = T.build(args)
    start, params, opt_state = T.init_state(model, args, dev)
    n_params = sum(t.numel() for t in leaves(params))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for step in range(start, steps):
        batch = T.batch_on(data.batch_at(step), dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = global_batch * seq_len
    per_step = launches["linear_attn"] / len(step_s)
    want = 2 * cfg.n_layers if cfg.family == "ssm" else 0
    batch = T.batch_on(data.batch_at(steps), dev)
    prof = profile_batch(lambda: step_fn(params, opt_state, batch), host_events=False)

    def forward():
        return model.loss(_requiring_grad(params), batch)

    grads = {}
    parts = dict(forward_ms=time_ms(forward, 2, warmup=1),
                 forward_backward_ms=time_ms(lambda: grads.update(
                     loss_and_grads(model, params, batch)[1]), 1, warmup=0))
    parts["backward_ms"] = parts["forward_backward_ms"] - parts["forward_ms"]
    opt_cfg = T.opt_config(args)
    parts["optimizer_ms"] = time_ms(lambda: apply_gradients(params, grads, opt_state, opt_cfg),
                                    3, warmup=1)
    del grads
    if cfg.family == "ssm":
        parts["row11_one_layer"] = row11_backward_ms(dev, seed, global_batch, cfg.n_heads,
                                                     seq_len, cfg.d_model // cfg.n_heads)
    smi = smi_line()
    emit(dict(phase="lm_train", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
              vocab=cfg.vocab_size, dtype=cfg.dtype, params=n_params, init_seconds=init_s,
              lr=lr, warmup_steps=T.opt_config(args).warmup_steps,
              steps=len(step_s), global_batch=global_batch, seq_len=seq_len,
              tokens_per_step=tokens, step_seconds=step_s,
              step_seconds_median=float(np.median(step_s)),
              tokens_per_s=tokens / float(np.median(step_s)), losses=losses,
              first_loss=losses[0], last_loss=losses[-1], max_memory_allocated=peak,
              linear_attn_launches=launches["linear_attn"],
              linear_attn_launches_per_step=per_step, launches=launches, parts=parts,
              profile=prof, nvidia_smi=smi))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"lm_train: the loss is not finite or did not fall: {losses}")
    if per_step != want or any(v for k, v in launches.items() if k != "linear_attn"):
        raise AssertionError(f"lm_train launched {launches}: row 11 should launch {want} "
                             "times a step (the forward and the remat recompute), no other")
    del params, opt_state
    torch.cuda.empty_cache()
    return launches


#: the sharded step's AdamW steps (and the unsharded step's, the same batches)
LM_SHARDED_STEPS = 3
LM_SHARE = ROOT / "build" / "dryrun" / "lm_share.json"


def fingerprint_mode(local: bool = False):
    """A dispatch mode recording a run: per ATen op with a floating output,
    its name, shape and the output's fp64 sum and sum of squares (``.rows``).
    ``local=True`` leaves an op on ``DTensor``s to DTensor and records the
    local ops it runs (the rank's own arithmetic)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Fingerprints(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if local and any(isinstance(a, DTensor) for a in tree_flatten([args, kwargs])[0]):
                return NotImplemented
            out = func(*args, **kwargs)
            if func.namespace == "aten" and not func.is_view:
                first = next((t for t in tree_flatten(out)[0]
                              if hasattr(t, "is_floating_point") and t.is_floating_point()
                              and t.numel()), None)
                if first is not None:
                    d = first.detach().double()
                    self.rows.append((func._opname, tuple(first.shape), d.sum(), (d * d).sum()))
            return out

    return Fingerprints()


def first_differing_op(cfg, mesh, shape, seed: int, batch_np: dict, dev) -> dict:
    """Where the sharded and the unsharded forward first part: ``cfg`` cut to
    one layer, the same weights and batch, the loss's forward under a
    :func:`fingerprint_mode` each way; the plain run's ops matched in
    order to the sharded run's local ops of the same name and shape (a
    sharded run adds redistributions); the first pair whose sums differ."""
    import dataclasses as dc

    import torch

    from repro_torch.launch import shardings as SH
    from repro_torch.models import Model
    from repro_torch.models.shard_ctx import sharded

    one = dc.replace(cfg, n_layers=1)
    model = Model(one)
    master = model.init(torch.Generator(dev).manual_seed(seed + 40))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    with torch.no_grad():
        plain = fingerprint_mode()
        with plain:
            model.loss(master, batch)
        params = SH.distribute_tree(mesh, SH.param_specs(one, mesh, master), master)
        dbatch = SH.distribute_tree(mesh, SH.batch_specs(one, mesh, shape, batch), batch)
        local = fingerprint_mode(local=True)
        with sharded(mesh), local:
            model.loss(params, dbatch)
    j = 0
    for i, (name, shp, s1, s2) in enumerate(plain.rows):
        while j < len(local.rows) and local.rows[j][:2] != (name, shp):
            j += 1
        if j == len(local.rows):
            return dict(index=i, op=name, shape=list(shp), unmatched=True)
        if not (torch.equal(s1, local.rows[j][2]) and torch.equal(s2, local.rows[j][3])):
            return dict(index=i, op=name, shape=list(shp), plain_sum=float(s1),
                        sharded_sum=float(local.rows[j][2]))
        j += 1
    return dict(index=None, ops=len(plain.rows))


def lm_sharded_phase(dev, seed: int, steps: int = LM_SHARDED_STEPS,
                     lr: float = 3e-4) -> tuple[dict, dict]:
    """The cell of ``launch.dryrun.share_prediction`` (``SHARE_ARCH`` x
    ``SHARE_SHAPE`` on a ``SHARE_MESH`` mesh: RWKV6-1.6B at full width, 8 x
    2,048 tokens a step, (1, 1, 1)) through the sharded train step
    (``launch.train.build(args, mesh)``: ``make_train_step(mesh=...)``) on a
    ``(1, 1, 1)`` ``DeviceMesh`` over NCCL at world size 1: the launcher's
    master from ``seed`` distributed by ``param_specs`` (at one rank each
    share is the whole tensor), ``steps`` AdamW steps of 8 x 2,048
    ``SyntheticLM`` tokens, bf16 compute, remat, peak lr 3e-4, then the
    same master (drawn again from the seed), batches and steps through the
    unsharded step.

    Reports whether the losses and the final params are bit-equal; if not,
    the largest differences, held to ``lm_train_recheck``'s tolerances (the
    loss to rtol 1e-5; the params to 1e-5 but for at most 0.1%, each within
    2 lr), and the first op of a one-layer forward whose output differs
    (:func:`first_differing_op`).  Also the step seconds both ways (the
    first of each includes its warm-up), a profiled sharded step (device
    idle share), row 11's launches a step (two a layer: the forward and the
    remat recompute) and the sharded steps' ``max_memory_allocated`` (its
    prediction, the fake run of the same cell, comes after the last timed
    phase: :func:`dryrun_prediction_phase`).  Fails if a step fails, a
    placement changes, row 11 launches otherwise, or the runs part beyond
    the tolerances.  Returns ``(launches, the record)``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import train as T
    from repro_torch.launch.dryrun import SHARE_ARCH, SHARE_MESH, SHARE_SHAPE
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train._tree import items
    from repro_torch.train.optimizer import init_opt_state

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else 0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        shape = SHARE_SHAPE
        mesh = make_mesh(SHARE_MESH, ("pod", "data", "model"), dev.type)
        args = train_args(arch=SHARE_ARCH, reduced=False, steps=steps,
                          global_batch=shape.global_batch, seq_len=shape.seq_len, seed=seed,
                          device=str(dev), lr=lr)
        cfg, model, step_sharded, data = T.build(args, mesh)
        step_plain = T.build(args)[2]

        def sharded_batch(step):
            batch = T.batch_on(data.batch_at(step), dev)
            return SH.distribute_tree(mesh, SH.batch_specs(cfg, mesh, shape, batch), batch)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_state(model, args, dev, mesh)[1]
        opt_state = init_opt_state(params)
        places = {p: tuple(t.placements) for p, t in items(params)}
        init_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        losses_s, secs_s = [], []
        for step in range(steps):
            batch = sharded_batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_sharded(params, opt_state, batch)
            losses_s.append(float(metrics["loss"].full_tensor()))  # the launcher's host read
            secs_s.append(time.perf_counter() - t0)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        moved = [p for p, t in items(params) if tuple(t.placements) != places[p]]
        moved += [p for p, t in items(opt_state["mu"]) if tuple(t.placements) != places[p]]
        prof = profile_batch(lambda: step_sharded(params, opt_state, sharded_batch(steps)),
                             host_events=False)
        final = {p: t.to_local() for p, t in items(params)}  # one rank: the whole tensor
        del params, opt_state, metrics
        torch.cuda.empty_cache()

        start, params, opt_state = T.init_state(model, args, dev)
        losses_p, secs_p = [], []
        for step in range(steps):
            batch = T.batch_on(data.batch_at(step), dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_plain(params, opt_state, batch)
            losses_p.append(float(metrics["loss"]))
            secs_p.append(time.perf_counter() - t0)
        del opt_state, metrics
        same = [torch.equal(final[p], t) for p, t in items(params)]
        worst, far, total = 0.0, 0, 0
        for p, t in items(params):
            d = (final[p].float() - t.float()).abs()
            worst, far, total = max(worst, float(d.max())), far + int((d > 1e-5).sum()), \
                total + d.numel()
        bit_equal = all(same) and losses_s == losses_p
        first = None if bit_equal else first_differing_op(cfg, mesh, shape, seed,
                                                          data.batch_at(0), dev)
        del params, final
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    want = 2 * cfg.n_layers
    per_step = launches["linear_attn"] / steps
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses_s, losses_p))
    out = dict(phase="lm_sharded", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               mesh=dict(pod=1, data=1, model=1), backend=backend, steps=steps,
               global_batch=shape.global_batch, seq_len=shape.seq_len, init_seconds=init_s,
               step_seconds_sharded=secs_s, step_seconds_unsharded=secs_p,
               step_seconds_median_sharded=float(np.median(secs_s)),
               step_seconds_median_unsharded=float(np.median(secs_p)),
               host_cost_ratio=float(np.median(secs_s) / np.median(secs_p)),
               losses_sharded=losses_s, losses_unsharded=losses_p, bit_equal=bit_equal,
               params_equal=f"{sum(same)} / {len(same)}", largest_param_diff=worst,
               params_far=far, params=total, largest_loss_rel_err=loss_err,
               first_differing_op=first, max_memory_allocated=peak,
               linear_attn_launches=launches["linear_attn"],
               linear_attn_launches_per_step=per_step, launches=launches,
               placements_changed=moved, profile=prof, nvidia_smi=smi_line())
    emit(out)
    if moved:
        raise AssertionError(f"lm_sharded: a step moved these leaves' placements: {moved[:5]}")
    if per_step != want or any(v for k, v in launches.items() if k != "linear_attn"):
        raise AssertionError(f"lm_sharded launched {launches}: row 11 should launch {want} "
                             "times a step (the forward and the remat recompute), no other")
    check_launched("lm_sharded", launches)
    if not bit_equal and not (loss_err <= 1e-5 and worst <= 2 * lr + 1e-6
                              and far <= 1e-3 * total):
        raise AssertionError(f"lm_sharded: the sharded step parts from the unsharded: {out}")
    return launches, out


def _requiring_grad(tree):
    """``tree``'s leaves detached and recording gradients, as a train step
    takes them."""
    return {k: _requiring_grad(v) if isinstance(v, dict) else v.detach().requires_grad_()
            for k, v in tree.items()}


def row11_inputs(g, dev, b: int, h: int, t: int, d: int, mode: str, dtype):
    """Row 11's ``(B, H, T, d)`` model-entry inputs: q, k at 0.3, v unit,
    decays in [0.5, 1], the bonus (``rwkv``) at 0.3, and a cotangent."""
    import torch

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    q, k, v = rand(b, h, t, d, scale=0.3), rand(b, h, t, d, scale=0.3), rand(b, h, t, d)
    w = (torch.rand((b, h, t, d), generator=g, device=dev) * 0.5 + 0.5).to(dtype)
    u = rand(h, d, scale=0.3) if mode == "rwkv" else None
    return [a for a in (q, k, v, w, u) if a is not None], rand(b, h, t, d)


def row11_backward_ms(dev, seed: int, b: int, h: int, t: int, d: int) -> dict:
    """One layer's row 11 in RWKV6's training shape, bf16, by CUDA events:
    the kernel's forward through ``linear_attention`` and the forward and
    backward (the plain version recomputed under autograd)."""
    import torch

    from repro_torch.kernels.linear_attn.ops import linear_attention

    g = torch.Generator(dev).manual_seed(seed + 40)
    args, ct = row11_inputs(g, dev, b, h, t, d, "rwkv", torch.bfloat16)
    live = [a.requires_grad_() for a in args]

    def both():
        return torch.autograd.grad((linear_attention(*live) * ct).sum(), live)

    fwd = time_ms(lambda: linear_attention(*live), 3, warmup=1)
    fb = time_ms(both, 3, warmup=1)
    return dict(shape=[b, h, t, d], forward_ms=fwd, forward_backward_ms=fb,
                backward_ms=fb - fwd)


def row11_grad_check(dev, seed: int, b: int, h: int, t: int, d: int, mode: str) -> dict:
    """Row 11's ``torch.autograd.Function`` on the card against autograd of
    its plain version on the card (fp32, the same inputs): the kernel's ``o``
    within rtol 1e-4 / atol 1e-4, every gradient within 1e-5 of its largest
    entry (the backward is that plain version, so equal bits are
    expected)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.linear_attn.ops import linear_attention
    from repro_torch.kernels.linear_attn.ref import linear_attn_chunked

    g = torch.Generator(dev).manual_seed(seed + 41)
    args, ct = row11_inputs(g, dev, b, h, t, d, mode, torch.float32)
    live = [a.clone().requires_grad_() for a in args]
    kernels.reset_launch_counts()
    o = linear_attention(*live, mode=mode)
    got = torch.autograd.grad((o * ct).sum(), live)
    n_launch = kernels.launch_counts()["linear_attn"]
    plain = [a.clone().requires_grad_() for a in args]
    uu = plain[4] if mode == "rwkv" else torch.zeros((h, d), device=dev)
    u_b = uu[None].expand(b, h, d).reshape(b * h, 1, d)
    pad = -(-t // 64) * 64 - t
    flat = [F.pad(a.reshape(b * h, t, d), (0, 0, 0, pad), value=val)
            for a, val in zip(plain[:4], (0.0, 0.0, 0.0, 1.0))]
    want_o = linear_attn_chunked(*flat, u_b, chunk=64, shift=int(mode == "rwkv"))[0]
    want_o = want_o[:, :t].reshape(b, h, t, d)
    want = torch.autograd.grad((want_o * ct).sum(), plain)
    o_err = float((o - want_o).detach().abs().max())
    errs = {n: float((a - w).abs().max() / w.abs().max().clamp(min=1e-30))
            for n, a, w in zip("qkvwu", got, want)}
    out = dict(mode=mode, shape=[b, h, t, d], launches=n_launch, o_max_abs_err=o_err,
               grad_rel_err=errs, equal_bits={n: bool(torch.equal(a, w))
                                              for n, a, w in zip("qkvwu", got, want)})
    if n_launch != 1 or not torch.allclose(o, want_o, rtol=1e-4, atol=1e-4) \
            or max(errs.values()) > 1e-5:
        raise AssertionError(f"row 11's autograd.Function disagrees with the plain version: {out}")
    return out


def lm_train_recheck_phase(dev, seed: int, arch: str, n_layers: int = 2, b: int = 1,
                           s: int = 128, lr: float = 1e-3) -> dict:
    """``arch`` at full width on ``n_layers`` layers in fp32: the same
    weights (drawn on the CPU) and one ``SyntheticLM`` batch on the card and
    on the CPU; the loss, every gradient leaf and the parameters after one
    AdamW step.  Tolerances: the loss to rtol 1e-5; each gradient leaf to
    ``tol`` of its largest entry (1e-4; 2e-3 for the ``ssm`` family, whose
    gradients pass through row 11's 3xTF32 kernel on the card and its
    log-space decays); the step's parameters to 1e-5, except at most 0.1%
    of them, which stay within ``2 * lr`` (Adam moves an element by about
    ``lr * sign(g)``, and a gradient within rounding of zero may take the
    other sign on the other device).  Row 11 must launch twice a layer on
    the card (the forward and the remat recompute)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train._tree import items
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    cfg = dc.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    model = Model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(seed + 20))
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(LMDataConfig(cfg.vocab_size, s, b, seed=seed + 21)).batch_at(0).items()}
    card = _to(cpu_params, dev)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    kernels.reset_launch_counts()
    lc, gc = loss_and_grads(model, card, card_batch)
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    lp, gp = loss_and_grads(model, cpu_params, batch)
    tol = 2e-3 if cfg.family == "ssm" else 1e-4
    grad_err = {path: float((a.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-30))
                for (path, a), (_, w) in zip(items(gc), items(gp))}
    step = make_train_step(model, OptConfig(lr=lr, warmup_steps=0, total_steps=10))
    pc, _, mc = step(card, init_opt_state(card), card_batch)
    pp, _, mp = step(cpu_params, init_opt_state(cpu_params), batch)
    cpu_s = time.perf_counter() - t0
    far = total = 0
    move = 0.0
    for (_, a), (_, w) in zip(items(pc), items(pp)):
        d = (a.cpu() - w).abs()
        move = max(move, float(d.max()))
        far, total = far + int((d > 1e-5).sum()), total + d.numel()
    worst = max(grad_err.values())
    out = dict(phase="lm_train_recheck", model=cfg.name, layers=n_layers,
               d_model=cfg.d_model, vocab=cfg.vocab_size, batch=b, seq_len=s,
               seconds_cpu=cpu_s, loss_card=float(lc), loss_cpu=float(lp),
               grad_norm_card=float(mc["grad_norm"]), grad_norm_cpu=float(mp["grad_norm"]),
               grad_leaves=len(grad_err), worst_grad_rel_err=worst,
               worst_grad_leaf=max(grad_err, key=grad_err.get), grad_tolerance=tol,
               step_params_far=far, step_params=total, step_largest_move_diff=move,
               linear_attn_launches=launches["linear_attn"])
    if cfg.family == "ssm":
        out["row11_autograd"] = [row11_grad_check(dev, seed, 2, cfg.n_heads, 200, 64, "rwkv"),
                                 row11_grad_check(dev, seed, 2, cfg.n_heads, 77, 64, "ssd")]
    emit(out)
    want = 2 * n_layers if cfg.family == "ssm" else 0
    if launches["linear_attn"] != want:
        raise AssertionError(f"the card's loss and gradients launched row 11 "
                             f"{launches['linear_attn']} times, not {want}")
    if not (abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp)) and worst <= tol
            and move <= 2 * lr + 1e-6 and far <= 1e-3 * total):
        raise AssertionError(f"the card's training step disagrees with the CPU's: {out}")
    return out


# ------------------------------ SC-attention ---------------------------------

#: the JAX package's long-context cell (``models/model.py``'s ``long_500k``)
SC_ATTENTION_S, SC_ATTENTION_H, SC_ATTENTION_HD = 524_288, 32, 128


def drifting_keys(g, dev, h: int, s: int, hd: int):
    """``examples/long_context_sc_attention.py``'s cache on ``dev``: keys
    N(0, 1) plus a per-head direction times a drift rising 0 -> 2 along the
    sequence, values N(0, 1), the query N(0, 1) plus the last key."""
    import torch

    keys = torch.randn((h, s, hd), generator=g, device=dev)
    drift = torch.linspace(0, 2, s, device=dev)[None, :, None]
    keys += drift * torch.randn((h, 1, hd), generator=g, device=dev)
    values = torch.randn((h, s, hd), generator=g, device=dev)
    q = torch.randn((h, hd), generator=g, device=dev) + keys[:, -1]
    return q, keys, values


def sc_attention_phase(dev, seed: int, s: int = SC_ATTENTION_S, h: int = SC_ATTENTION_H,
                       hd: int = SC_ATTENTION_HD, n_keeps=(512, 2048, 8192),
                       small=(2, 65_536)) -> dict:
    """SC-attention (``repro_torch.core.sc_attention``) over the
    ``long_500k`` context at ``h`` heads of ``hd`` in fp32, at each
    ``n_keep``: ms a call by CUDA events against exact full attention on
    the card, attention-mass recall (mean and min over the heads) and the
    largest |error| against exact attention.  Then a reduced case (``small``
    = heads, keys) on the card and on the CPU: the SC-scores equal except
    where a partial product lies within a few ulp of its ``tau``, and the
    selected ids equal where the scores are.  No port kernel runs."""
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.core import sc_attention as A

    g = torch.Generator(dev).manual_seed(seed + 30)
    q, keys, values = drifting_keys(g, dev, h, s, hd)

    def exact():
        w = torch.softmax(torch.matmul(keys, q[..., None])[..., 0] / math.sqrt(hd), dim=-1)
        return torch.matmul(w[:, None], values)[:, 0]

    kernels.reset_launch_counts()
    want = exact()
    exact_ms = time_ms(exact, 5)
    rows = []
    for n_keep in n_keeps:
        out, ids = A.sc_sparse_attention(q, keys, values, n_keep=n_keep)
        mass = A.attention_mass_recall(q, keys, ids)
        ms = time_ms(lambda: A.sc_sparse_attention(q, keys, values, n_keep=n_keep), 5)
        rows.append(dict(n_keep=n_keep, share_of_keys=n_keep / s, ms=ms,
                         exact_ms=exact_ms, recall_mean=float(mass.mean()),
                         recall_min=float(mass.min()),
                         max_abs_err=float((out - want).abs().max())))
    launches = kernels.launch_counts()
    del keys, values
    hs, ss = small
    gs = torch.Generator(dev).manual_seed(seed + 31)
    q2, k2, v2 = drifting_keys(gs, dev, hs, ss, hd)
    count = max(1, int(0.05 * ss))
    card_sc = A.sc_key_scores(q2, k2, 4, count).cpu()
    cpu_sc = A.sc_key_scores(q2.cpu(), k2.cpu(), 4, count)
    apart = card_sc != cpu_sc
    near = _tau_ties(q2.cpu().double(), k2.cpu().double(), 4, count)
    card_ids = A.sc_select_keys(q2, k2, n_keep=2048).cpu()
    cpu_ids = A.sc_select_keys(q2.cpu(), k2.cpu(), n_keep=2048)
    out = dict(phase="sc_attention", heads=h, keys=s, head_dim=hd, dtype="float32",
               kv_bytes=2 * h * s * hd * 4, n_subspaces=4, alpha=0.05, cases=rows,
               launches=launches,
               small=dict(heads=hs, keys=ss, scores_apart=int(apart.sum()),
                          apart_off_tau_ties=int((apart & ~near).sum()),
                          ids_equal=bool(torch.equal(card_ids, cpu_ids))))
    emit(out)
    if any(launches.values()):
        raise AssertionError(f"sc_attention launched {launches}; it runs no port kernel")
    if out["small"]["apart_off_tau_ties"] or (not apart.any() and not out["small"]["ids_equal"]):
        raise AssertionError(f"the card's SC-attention selection disagrees with the CPU's: {out}")
    if not all(r["recall_mean"] > 0 and math.isfinite(r["max_abs_err"]) for r in rows):
        raise AssertionError("sc_attention gave no finite answer")
    return out


def _tau_ties(q, keys, n_subspaces: int, count: int, rel: float = 1e-5):
    """``(H, S)``: keys whose partial product in some subspace lies within
    ``rel`` of that subspace's ``count``-th smallest (fp64 inputs)."""
    import torch

    h, s, hd = keys.shape
    w = hd // n_subspaces
    near = torch.zeros((h, s), dtype=torch.bool)
    for i in range(n_subspaces):
        d = -torch.einsum("hsw,hw->hs", keys[..., i * w:(i + 1) * w], q[:, i * w:(i + 1) * w])
        tau = torch.sort(d, dim=-1).values[:, count - 1]
        near |= (d - tau[:, None]).abs() <= rel * tau[:, None].abs() + 1e-6
    return near


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
    smi = smi_line()
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

    # 3b. the static gate on the card: resource use, limits, the two merges
    static_gate_phase(engine, data, q64, cfg, k)

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

    # 9b. the sharded engine at world size 1 over NCCL (configs A and B), then
    # the paper's competitor baselines at fig9_12's sizes and at 1M
    launches_by_path["sharded_serve"], sharded_checks = sharded_serve_phase(
        x_np, data, q64, gt, rec, args.seed)
    launches_by_path["baselines"] = baselines_phase(x_np, data, q64, gt, args.seed)

    # 9c. rank 0's share of the 1B x 128 sharded dry-run, run for real (the
    # fake run's prediction of its memory comes after the last timed phase)
    launches_by_path["dryrun_suco"], dryrun_checks, dryrun_run = dryrun_suco_phase(args.seed)

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
    checks.update(sharded_checks)
    checks.update(dryrun_checks)
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

    del cpu_engine, cpu_res, card_res

    # 12b. training: RWKV6-1.6B trained at full width through the launcher's
    # functions (row 11 in the forward and the remat recompute, its backward
    # the plain version); RWKV6 and granite-3-2b at full width on 2 layers in
    # fp32 on the card and again on the CPU; then SC-attention over the
    # long_500k context.  After the kernel checks, whose traces it could upset
    torch.cuda.empty_cache()
    launches_by_path["lm_train"] = lm_train_phase(dev, args.seed)
    torch.cuda.empty_cache()
    # 12c. the same model through the sharded step on a (1, 1, 1) mesh over
    # NCCL, against the unsharded step on the same seed and batches
    launches_by_path["lm_sharded"], lm_sharded_run = lm_sharded_phase(dev, args.seed)
    torch.cuda.empty_cache()
    for arch in ("rwkv6-1.6b", "granite-3-2b"):
        lm_train_recheck_phase(dev, args.seed, arch)
    sc_attention_phase(dev, args.seed)
    torch.cuda.empty_cache()

    # 13. the hybrid LM family: Zamba2-1.2B served at full width (row 11 in SSD
    # mode, once a Mamba2 layer per prefill batch), then 3 layers of that
    # width at period 2 (one unit, the shared block, a tail layer) on the card
    # and again on the CPU
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

    # 15. the cross-attention families: Llama-3.2-Vision-11B (a gated cross
    # block every 5th layer over 1,601 patch embeddings) and Whisper-large-v3
    # (an encoder over 1,500 frames; 224-token prompts, inside its decoder's
    # published 448-token context) served at full width, nothing cut; then 2
    # layers of each width (the VLM at period 2: one dense layer, one cross
    # block, gates open) on the card and again on the CPU over seeded extras
    vlm_cfg = get_config("llama-3.2-vision-11b")
    launches_by_path["lm_serve_vlm"] = lm_serve_phase(dev, args.seed, vlm_cfg,
                                                      phase="lm_serve_vlm")
    audio_cfg = get_config("whisper-large-v3")
    launches_by_path["lm_serve_audio"] = lm_serve_phase(dev, args.seed, audio_cfg,
                                                        phase="lm_serve_audio", prompt_len=224)
    lm_cpu_recheck_phase(dev, args.seed,
                         dataclasses.replace(vlm_cfg, n_layers=2, cross_attn_period=2),
                         phase="lm_cpu_recheck_vlm")
    lm_cpu_recheck_phase(dev, args.seed,
                         dataclasses.replace(audio_cfg, n_layers=2, encoder_layers=2),
                         phase="lm_cpu_recheck_audio")

    # 16. the dense LM family: Gemma2-9B served at full width, then a 2-layer
    # Gemma2 of that width (layer 0 local at reduced_config's window of 32,
    # layer 1 global) on the card and again on the CPU.  Last, after every
    # kernel is timed: traces taken after it lose their kernels far more often
    dense_cfg = get_config("gemma2-9b")
    launches_by_path["lm_serve_dense"] = lm_serve_phase(dev, args.seed, dense_cfg,
                                                        phase="lm_serve_dense")
    lm_cpu_recheck_phase(dev, args.seed,
                         dataclasses.replace(dense_cfg, n_layers=2, local_window=32),
                         phase="lm_cpu_recheck_dense")

    # 17. the dry-runs' fake predictions of the dryrun_suco program's and the
    # lm_sharded step's memory, together, on the host alone: no timed phase
    # runs beside them
    dryrun_prediction_phase(dryrun_run, lm_sharded_run)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        rec_ = checks[name]
        path = PATH_OF.get(name)
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=sum(launches_by_path[p_][name]
                                      for p_ in (path, *ALSO_ON.get(name, ())) if p_),
                         path=path,
                         launches_by_path={p_: c[name] for p_, c in launches_by_path.items()},
                         max_abs_err=rec_["max_abs_err"],
                         ms=rec_["ms"], ms_clock=rec_.get("ms_clock"),
                         call_ms=rec_["call_ms"], plain_ms=rec_["plain_ms"],
                         bound_ms=rec_["bound_ms"], bound_by=rec_["bound_by"],
                         library_ms=rec_["library_ms"]))
        extras = ("fp32_bound_ms", "tf32_bound_ms", "rechecks_per_point", "variant",
                  "rechecks_per_pair", "screen_err_over_margin", "max_screen_err_over_margin",
                  "equal_bits", "instantiations", "fingerprint",
                  "parent_fingerprint", "q", "tile", "bitmap_route", "smem_bytes", "l2_route",
                  "in_path", "ids", "group", "vec", "per_thread", "distinct_rows",
                  "scattered_read", "library")
        rows[-1].update({key: rec_["detail"][key] for key in extras
                         if key in rec_.get("detail", {})})
        if name == "sc_score_cells_prefilter_compact":  # its time in the profiled batches
            for m, p_ in profiles.items():
                rows[-1]["in_path"][str(m)]["profile"] = compact_in_profile(p_)
        # rows 3-5 at the IVF shapes ("wide"), row 3 at PQ8x8's ("pq"), row 7
        # over all n columns ("dense"), row 11 at Zamba2's SSD shape ("ssd"),
        # rows 2, 3, 4, 7 at the sharded path's and the dry-run share's shapes,
        # row 2 at the baselines' d = 64 ("d64")
        for variant in ("wide", "pq", "dense", "ssd", "sharded", "dryrun", "d64"):
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
