#!/usr/bin/env python3
"""Time the batched assignment op (row 5 of the kernel table) on the card's
own clock at five shapes of s <= 64, beside its narrow and screened kernels
forced on the same shapes, and split PQ8x8 training's time between rows 3
and 5.

    python3 tools/time_assign.py [--src DIR] [--label NAME] [--seed S] [--quick]

The options are the card timers' (``tools/_ab.py``): ``--src`` times another
checkout's ``src``, so one command can time two checkouts in turns (parent,
change, change, parent), each in its own process.  The inputs are
``chip_smoke.py``'s: ``gaussian_mixture`` at SIFT1M's shape (n = 1M,
d = 128) from ``--seed``, then

* ``pq``: PQ8x8's (8, 1M, 16) sub-vectors against its trained codebooks,
  k = 256, chunks of 4,096 (``pq_inputs``, then 20 Lloyd steps);
* ``build``: the SuCo build's (16, 1M, 8) half-subspaces against the
  default index's centroids, k = 50 (``build_stats_inputs``: row 4's shape);
* ``wide_narrow``: the first 64 dims of IVF1024's 262,144-row sample,
  (1, 262,144, 64), against 256 centroids trained on it (20 Lloyd steps
  from a seeded random start), chunks of 2,048 (``ivf_sample``);
* ``wide_narrow_k50``, ``wide_narrow_k128``: the same rows against 50 and
  128 centroids trained the same way.

Per shape and variant -- ``op`` (the op's own route,
``ops.kmeans_assign_batched``), ``narrow`` and ``screen`` (the narrow and
the 3xTF32 screened kernel forced on the same inputs,
``kernel.kmeans_assign_batched(..., wide)``) -- ``ms`` (the device
time of one call, ``chip_smoke.device_ms``: the median of 5 readings of
``REPS`` calls, each reading kept), ``call_ms`` (CUDA events around ``REPS``
back-to-back calls, the median of 5 readings), whether the argmins equal
the plain version's and two launches' bits, a fingerprint that trees must
share, and the re-checked pairs per point of each forced kernel (its
probe, where the tree has one).  PQ8x8 training (20 chunked
Lloyd steps, then the final assignment): ``WALL_REPS`` readings on the host
clock ending in a synchronise, and one training under the profiler (device
busy, idle share, the port's kernels with their time and launches).  Rows
3, 4 and 6 at ``chip_smoke.py``'s shapes (``others``: the statistics at the
build's and PQ8x8's shapes, the pair assignment at the build's, IVF1024's
assignment of the 1M rows against its kmeans++ seeds): ``ms`` and a
fingerprint of each output, which row 5's changes must leave alone.
With ``--quick``, the op's route alone and no training (for variants of
the kernel).  Prints the tree's ``-Xptxas -v`` lines for ``kmeans_assign.cu``
and one JSON line with ``nvidia-smi``'s name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import inspect
import json
import sys

import _ab

REPS = 10  # calls a device reading and a call reading time
WALL_REPS = 5  # trainings timed on the host clock


def main() -> int:
    args, chip_smoke, out = _ab.start(__doc__, "time_assign", {
        "--quick": "only the op's route at each shape: no screened variant, no training"})
    import torch

    from repro_torch.core import kmeans as km
    from repro_torch.core.suco import SuCoConfig, build_index
    from repro_torch.data import gaussian_mixture
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import kernel, ops
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_batched_ref

    dev = torch.device("cuda")
    data = torch.from_numpy(gaussian_mixture(1_000_000, 128, args.seed)).to(dev)
    iters, k_pq, bn_pq = chip_smoke.LLOYD_ITERS, chip_smoke.PQ_K, chip_smoke.PQ_BLOCK_N
    xs, c0 = chip_smoke.pq_inputs(data, args.seed)

    def train_pq():
        return km.kmeans_batched(xs, k_pq, iters, block_n=bn_pq, init_centroids=c0)

    c_pq = train_pq().centroids
    cfg = SuCoConfig()
    index = build_index(data, cfg)
    both = chip_smoke.build_stats_inputs(data, index.spec, cfg)[0]
    c_build = torch.cat([index.centroids1, index.centroids2]).contiguous()
    del index
    x64 = chip_smoke.ivf_sample(data, args.seed)[:, :64].contiguous()[None]

    def train64(k):
        start = km.init_random(x64, k, torch.Generator().manual_seed(args.seed + 6))
        return km.kmeans_batched(x64, k, iters, block_n=chip_smoke.IVF_BLOCK_N,
                                 init_centroids=start).centroids

    shapes = {"pq": (xs, c_pq, bn_pq), "build": (both, c_build, cfg.block_n),
              "wide_narrow": (x64, train64(256), chip_smoke.IVF_BLOCK_N),
              "wide_narrow_k50": (x64, train64(50), chip_smoke.IVF_BLOCK_N),
              "wide_narrow_k128": (x64, train64(128), chip_smoke.IVF_BLOCK_N)}

    # a tree whose entry still takes block_n (the parent of its removal)
    with_bn = "block_n" in inspect.signature(kernel.kmeans_assign_batched).parameters

    def forced(x, c, bn, wide):
        return kernel.kmeans_assign_batched(x, c, *((bn,) if with_bn else ()), wide)

    narrow_probe = getattr(kernel, "kmeans_assign_narrow_probe", None)
    variants = ("op",) if args.quick else ("op", "narrow", "screen")
    out.update(shapes={})
    for name, (x, c, bn) in shapes.items():
        want = kmeans_assign_batched_ref(x, c, block_n=bn)
        rec = dict(shape=list(x.shape), k=c.shape[1], block_n=bn)
        for variant in variants:
            def fn(x=x, c=c, bn=bn, variant=variant):
                if variant == "op":
                    return ops.kmeans_assign_batched(x, c, block_n=bn)
                return forced(x, c, bn, variant == "screen")

            first, second = fn(), fn()
            dev_t = chip_smoke.device_ms(fn, REPS)
            calls_t = _ab.readings(chip_smoke, fn, REPS, 5)
            probe = {"narrow": narrow_probe, "screen": kernel.kmeans_assign_probe}.get(variant)
            rechecks = None
            if probe is not None:
                rechecks = float(probe(x, c).rechecks.sum()) / (x.shape[0] * x.shape[1])
            rec[variant] = dict(
                ms=dev_t["ms"], ms_readings=dev_t["readings"],
                events_per_call=dev_t["events_per_call"], events_lost=dev_t["events_lost"],
                retakes=dev_t["retakes"], call_ms=calls_t["ms"],
                call_ms_readings=calls_t["readings"], reps=REPS,
                equal_plain=torch.equal(first, want), equal_bits=torch.equal(first, second),
                fingerprint=chip_smoke.fingerprint(first), rechecks_per_point=rechecks)
            del first, second
        out["shapes"][name] = rec
        del want
    if not args.quick:
        out["pq_training"] = dict(wall_s=_ab.wall(train_pq, WALL_REPS),
                                  profile=chip_smoke.profile_batch(train_pq))
        # rows 3, 4 and 6 at chip_smoke's shapes: their bits and times must
        # not move with row 5's redesign
        c_ivf = chip_smoke.ivf_seeds(data, args.seed)
        others = {
            "stats_build": lambda: ops.kmeans_stats(both, c_build, block_n=cfg.block_n,
                                                    with_assign=True),
            "stats_pq": lambda: ops.kmeans_stats(xs, c_pq, block_n=bn_pq, with_assign=True),
            "pair_build": lambda: ops.kmeans_pair_assign_hist(both, c_build,
                                                              block_n=cfg.block_n),
            "assign_ivf": lambda: ops.kmeans_assign(data, c_ivf),
        }
        out["others"] = {}
        for name, fn in others.items():
            first = fn()
            first = first if isinstance(first, tuple) else (first,)
            dev_t = chip_smoke.device_ms(fn, REPS)
            out["others"][name] = dict(ms=dev_t["ms"], ms_readings=dev_t["readings"],
                                       fingerprints=[chip_smoke.fingerprint(t) for t in first])
            del first
    out["ptxas"] = _build.ptxas_report("kmeans_assign")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
