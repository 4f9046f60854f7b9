#!/usr/bin/env python3
"""Time the Lloyd-statistics op (row 3 of the kernel table) on the card at
the three shapes its paths give it, and the three trainings that launch it.

    python3 tools/time_stats.py [--src DIR] [--label NAME] [--seed S]

The options are the card timers' (``tools/_ab.py``): ``--src`` times another
checkout's ``src``, so one command can time two checkouts in turns (parent,
change, change, parent), each in its own process.  The inputs are
``chip_smoke.py``'s, from its own helpers: ``gaussian_mixture`` at SIFT1M's
shape (n = 1M, d = 128) from ``--seed``, then

* ``build``: the SuCo build's 16 half-subspaces of 8 dims and its seeded
  start, k = 50, chunks of 4,096 (``build_stats_inputs``);
* ``pq``: PQ8x8's (8, 1M, 16) sub-vectors and start, k = 256, chunks of
  4,096 (``pq_inputs``);
* ``ivf``: IVF1024's 262,144-row sample at d = 128 against its 1,024
  kmeans++ seeds, chunks of 2,048 (``ivf_sample``, ``ivf_seeds``).

Per shape: the mean ms of ``REPS`` launches by CUDA events (after warm-up),
and whether two launches gave equal bits.  End to end, on the host clock
ending in a synchronise, ``WALL_REPS`` readings each (all printed, and their
median): the default SuCo build at 1M, PQ8x8 training (20 chunked Lloyd
steps) and IVF1024 Lloyd training (20 steps).  Prints one JSON line with
``nvidia-smi``'s name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from functools import partial

import _ab

REPS = 10  # launches timed per shape
WALL_REPS = 5  # end-to-end readings per training


def main() -> int:
    args, chip_smoke, out = _ab.start(__doc__, "time_stats")
    import torch

    from repro_torch.core import kmeans as km
    from repro_torch.core.suco import SuCoConfig, build_index
    from repro_torch.data import gaussian_mixture
    from repro_torch.kernels.kmeans_assign import ops

    dev = torch.device("cuda")
    data = torch.from_numpy(gaussian_mixture(1_000_000, 128, args.seed)).to(dev)
    cfg = SuCoConfig()
    both, c_build = chip_smoke.build_stats_inputs(data, build_index(data, cfg).spec, cfg)
    xs, c_pq = chip_smoke.pq_inputs(data, args.seed)
    sample = chip_smoke.ivf_sample(data, args.seed)
    c_ivf = chip_smoke.ivf_seeds(data, args.seed)
    shapes = {"build": (both, c_build, cfg.block_n),
              "pq": (xs, c_pq, chip_smoke.PQ_BLOCK_N),
              "ivf": (sample[None], c_ivf[None], chip_smoke.IVF_BLOCK_N)}

    out.update(shapes={}, end_to_end_s={})
    for name, (x, c, bn) in shapes.items():
        first = ops.kmeans_stats(x, c, block_n=bn, with_assign=True)
        second = ops.kmeans_stats(x, c, block_n=bn, with_assign=True)
        out["shapes"][name] = dict(
            shape=list(x.shape), k=c.shape[1], block_n=bn,
            ms=chip_smoke.time_ms(partial(ops.kmeans_stats, x, c, block_n=bn), REPS),
            equal_bits=all(torch.equal(a, b) for a, b in zip(first, second)))
    iters = chip_smoke.LLOYD_ITERS
    out["end_to_end_s"] = dict(
        build=_ab.wall(lambda: build_index(data, cfg), WALL_REPS),
        pq_training=_ab.wall(lambda: km.kmeans_batched(xs, chip_smoke.PQ_K, iters,
                                                       block_n=chip_smoke.PQ_BLOCK_N,
                                                       init_centroids=c_pq), WALL_REPS),
        ivf_training=_ab.wall(lambda: km.kmeans(sample, chip_smoke.IVF_K, iters,
                                                block_n=chip_smoke.IVF_BLOCK_N,
                                                init_centroids=c_ivf), WALL_REPS))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
