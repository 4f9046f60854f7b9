#!/usr/bin/env python3
"""Time SC-Linear's kernels (rows 9 and 10 of the kernel table) on the
card's own clock at the shapes its path gives them, and the SC-Linear
batches that launch them.

    python3 tools/time_sc_linear.py [--src DIR] [--label NAME] [--seed S]
                                    [--batches]

The options are the card timers' (``tools/_ab.py``): ``--src`` times another
checkout's ``src``, so one command can time two checkouts in turns (parent,
change, change, parent), each in its own process.  The inputs are
``chip_smoke.py``'s: ``gaussian_mixture`` at SIFT1M's shape (n = 1M,
d = 128) from ``--seed``, 64 queries (``make_queries``), Ns = 8 contiguous
subspaces of s = 16 (strided views, as ``sc_linear_query`` passes them)
and each query's threshold from row 10's distances
(``chip_smoke.sc_linear_inputs``: the 50,000-th smallest, alpha = 0.05).
Row 9 (``sc_scores_fused``) runs at m = 1, 8 and 64 (``fused_<m>``: the
first m queries and their thresholds); row 10 (``pairwise_sqdist``) over
one subspace at m = 1, 8, 32 and 64 (``pairwise_<m>``: the first m queries;
32 is one query tile of the SIMT kernel that row 10 replaced, which read x
once there and twice at 64).

Per shape: ``ms``, the device time of one call (``chip_smoke.device_ms``:
the profiler's kernel time over ``REPS`` calls, the median of 5 readings,
every reading kept), ``call_ms`` (CUDA events around ``REPS`` back-to-back
calls, the median of 5 readings), the device events one call launches,
whether two launches gave equal bits, and a fingerprint of the output that
two trees must share.  With ``--batches``, SC-Linear batches of 8 and 64
queries (``sc_linear_query``, k = 10, alpha = 0.05, beta = 0.02):
``WALL_REPS`` readings on the host clock ending in a synchronise, and one
batch under the profiler (device busy, idle share, top kernels, the port's
kernels).  Prints the tree's ``-Xptxas -v`` lines for the two kernels'
sources and one JSON line with ``nvidia-smi``'s name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import _ab

REPS = 10  # calls a device reading and a call reading time
WALL_REPS = 5  # batches timed on the host clock


def main() -> int:
    args, chip_smoke, out = _ab.start(__doc__, "time_sc_linear", {
        "--batches": "also time SC-Linear batches of 8 and 64 queries"})
    import torch

    from repro_torch import sc_linear_query
    from repro_torch.core import subspace as sub
    from repro_torch.data import gaussian_mixture, make_queries
    from repro_torch.kernels import _build
    from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
    from repro_torch.kernels.sc_score import ops as score_ops

    dev = torch.device("cuda")
    x_np = gaussian_mixture(1_000_000, 128, args.seed)
    data = torch.from_numpy(x_np).to(dev)
    q64 = torch.from_numpy(make_queries(x_np, 64, seed=args.seed + 1)).to(dev)
    qs, xs, tau, count = chip_smoke.sc_linear_inputs(data, q64, 8)

    calls = {f"fused_{m}": lambda m=m: score_ops.sc_scores_fused(qs[:, :m], xs,
                                                                 tau[:, :m].contiguous())
             for m in (1, 8, 64)}
    calls.update({f"pairwise_{m}": lambda m=m: pairwise_ops.pairwise_sqdist(qs[0, :m], xs[0])
                  for m in (1, 8, 32, 64)})
    out.update(n=xs.shape[1], ns=xs.shape[0], s=xs.shape[2], collision_count=count, shapes={})
    for name, fn in calls.items():
        first, second = fn(), fn()
        dev_t = chip_smoke.device_ms(fn, REPS)
        calls_t = _ab.readings(chip_smoke, fn, REPS, 5)
        out["shapes"][name] = dict(
            ms=dev_t["ms"], ms_readings=dev_t["readings"],
            events_per_call=dev_t["events_per_call"], events_lost=dev_t["events_lost"],
            retakes=dev_t["retakes"],
            call_ms=calls_t["ms"], call_ms_readings=calls_t["readings"], reps=REPS,
            equal_bits=torch.equal(first, second), fingerprint=chip_smoke.fingerprint(first))
        del first, second
    out["ptxas"] = {name: _build.ptxas_report(name) for name in ("pairwise_l2", "sc_score_fused")
                    if name in _build.SOURCES}
    if args.batches:
        spec = sub.contiguous_spec(data.shape[1], 8)
        out["batches"] = {}
        for m in (8, 64):
            def batch(m=m):
                return sc_linear_query(data, q64[:m], spec=spec, k=10, alpha=0.05, beta=0.02)

            out["batches"][f"sc_linear_{m}"] = dict(wall_s=_ab.wall(batch, WALL_REPS),
                                                    profile=chip_smoke.profile_batch(batch))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
