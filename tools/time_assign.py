#!/usr/bin/env python3
"""Time the assignment ops on the card's own clock: the batched assignment
(row 5 of the kernel table) at five shapes of s <= 64, beside its narrow and
screened kernels forced on the same shapes, the paired assignment with the
IMI histogram (row 4) at both its routes, and rows 3 and 6 beside them; and
split PQ8x8 training's time between rows 3 and 5.

    python3 tools/time_assign.py [--src DIR] [--label NAME] [--seed S] [--quick | --pair]

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
build's and PQ8x8's shapes, the pair assignment at the build's (its narrow
route) and at (2, 262,144, 128), k = 256 and 128 (its wide route,
``chip_smoke.pair_wide_inputs``; at k = 128 the k^2 histogram fits shared
memory, at 256 it does not), IVF1024's assignment of the 1M rows
against its kmeans++ seeds): ``ms``, each reading, whether the outputs
equal the plain version's and ``nvidia-smi``'s SM clock and power while it
runs back to back (the pair assignment's: ``_ab.clocks``), and a fingerprint of
each output, which a change to another row must leave alone; the narrow
pair route's re-checked (point, half)s per point, where the tree has its
probe.  With ``--quick``, row 5 at the op's route alone and no training
(for variants of the kernel); with ``--pair``, row 4 alone.  Prints the
tree's ``-Xptxas -v`` lines for ``kmeans_assign.cu``; ``pair_sass``: the
instructions of the narrow pair kernel's inner loop at s = 8 from
``cuobjdump -sass`` (the loop, a backward branch's body, densest in FFMA /
FMUL; its opcodes counted, and per (point, centroid) pair: 8 of
its FFMA or FMUL make one pair's products); and one JSON line with
``nvidia-smi``'s name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import collections
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import _ab

REPS = 10  # calls a device reading and a call reading time
WALL_REPS = 5  # trainings timed on the host clock


#: the narrow pair kernel at s = 8 (the build's width), without its probe
PAIR_KERNEL_8 = re.compile(r"kmeans_pair_assign_hist_kernelILi8E(Lb0E)?E")


def pair_sass(lib: Path) -> dict:
    """The inner loop of the narrow pair kernel at s = 8 in ``lib``'s SASS:
    among the bodies of its backward branches (a target given as a label or
    as an address), the one densest in FFMA and FMUL; its instructions,
    its opcodes counted, and its instructions per (point, centroid) pair (8
    FFMA or FMUL a pair's products at s = 8)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not PAIR_KERNEL_8.search(name):
            continue
        code, at, loops = [], {}, []  # at: a label's or an address's instruction index
        for line in part.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                at[label.group(1)] = len(code)
                continue
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not ins:
                continue
            at[f"0x{int(ins.group(1), 16):x}"] = len(code)
            code.append(ins.group(2))
            target = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", ins.group(2))
            if target:
                key = target.group(1)
                key = f"0x{int(key, 16):x}" if key.startswith("0x") else key
                if at.get(key, len(code)) < len(code) - 1:
                    loops.append(code[at[key]:])
        def ops(body):
            return [(c.split()[1] if c.startswith("@") else c.split()[0]).split(".")[0]
                    for c in body]
        def products(body):
            return sum(o in ("FFMA", "FMUL") for o in ops(body))

        # the innermost loop of the products: the densest in them (an outer
        # loop holds the inner one's products among many more instructions)
        body = max((b for b in loops if products(b) >= 8),
                   key=lambda b: products(b) / len(b), default=[])
        count = collections.Counter(ops(body))
        pairs = (count["FFMA"] + count["FMUL"]) / 8
        return dict(function=name, loop_instructions=len(body), pairs_per_iteration=pairs,
                    per_pair=len(body) / pairs if pairs else None,
                    opcodes=dict(count.most_common()), loop=body)
    return {}


def main() -> int:
    args, chip_smoke, out = _ab.start(__doc__, "time_assign", {
        "--quick": "only the op's route at each shape: no screened variant, no training",
        "--pair": "row 4 alone (its two shapes), for variants of its kernel"})
    import torch

    from repro_torch.core import kmeans as km
    from repro_torch.core.suco import SuCoConfig, build_index
    from repro_torch.data import gaussian_mixture
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import kernel, ops
    from repro_torch.kernels.kmeans_assign.ref import (
        kmeans_assign_batched_ref,
        kmeans_pair_assign_hist_ref,
    )

    dev = torch.device("cuda")
    data = torch.from_numpy(gaussian_mixture(1_000_000, 128, args.seed)).to(dev)
    iters, k_pq, bn_pq = chip_smoke.LLOYD_ITERS, chip_smoke.PQ_K, chip_smoke.PQ_BLOCK_N
    xs, c0 = chip_smoke.pq_inputs(data, args.seed)

    def train_pq():
        return km.kmeans_batched(xs, k_pq, iters, block_n=bn_pq, init_centroids=c0)

    c_pq = None if args.pair else train_pq().centroids
    cfg = SuCoConfig()
    index = build_index(data, cfg)
    both = chip_smoke.build_stats_inputs(data, index.spec, cfg)[0]
    c_build = torch.cat([index.centroids1, index.centroids2]).contiguous()
    del index

    x64 = None if args.pair else chip_smoke.ivf_sample(data, args.seed)[:, :64].contiguous()[None]

    def train64(k):
        start = km.init_random(x64, k, torch.Generator().manual_seed(args.seed + 6))
        return km.kmeans_batched(x64, k, iters, block_n=chip_smoke.IVF_BLOCK_N,
                                 init_centroids=start).centroids

    shapes = {} if args.pair else {
        "pq": (xs, c_pq, bn_pq), "build": (both, c_build, cfg.block_n),
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
    if not (args.quick or args.pair):
        out["pq_training"] = dict(wall_s=_ab.wall(train_pq, WALL_REPS),
                                  profile=chip_smoke.profile_batch(train_pq))
    # rows 3, 4 and 6 at chip_smoke's shapes: a change to one row must leave
    # the others' bits and times alone
    halves, c_wide = chip_smoke.pair_wide_inputs(data, args.seed)
    pairs = {"pair_build": (both, c_build, cfg.block_n),
             "pair_wide": (halves, c_wide, chip_smoke.IVF_BLOCK_N),
             "pair_wide_k128": (halves, c_wide[:, :128].contiguous(), chip_smoke.IVF_BLOCK_N)}
    others = {name: (lambda x=x, c=c, bn=bn: ops.kmeans_pair_assign_hist(x, c, block_n=bn))
              for name, (x, c, bn) in pairs.items()}
    if not args.pair:
        c_ivf = chip_smoke.ivf_seeds(data, args.seed)
        others.update(
            stats_build=lambda: ops.kmeans_stats(both, c_build, block_n=cfg.block_n,
                                                 with_assign=True),
            stats_pq=lambda: ops.kmeans_stats(xs, c_pq, block_n=bn_pq, with_assign=True),
            assign_ivf=lambda: ops.kmeans_assign(data, c_ivf))
    out["others"] = {}
    for name, fn in others.items():
        first = fn()
        first = first if isinstance(first, tuple) else (first,)
        dev_t = chip_smoke.device_ms(fn, REPS)
        rec = dict(ms=dev_t["ms"], ms_readings=dev_t["readings"],
                   fingerprints=[chip_smoke.fingerprint(t) for t in first])
        if name in pairs:
            x, c, bn = pairs[name]
            rec["equal_plain"] = all(torch.equal(a, b) for a, b in zip(
                first, kmeans_pair_assign_hist_ref(x, c, block_n=bn)))
            rec["clocks"] = _ab.clocks(fn)
        out["others"][name] = rec
        del first
    pair_probe = getattr(kernel, "kmeans_pair_assign_hist_probe", None)
    if pair_probe is not None:
        out["others"]["pair_build"]["rechecks_per_point"] = float(
            pair_probe(both, c_build).rechecks.sum()) / (both.shape[0] * both.shape[1])
    out["pair_sass"] = pair_sass(_build.library_path("kmeans_assign"))
    out["ptxas"] = _build.ptxas_report("kmeans_assign")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
