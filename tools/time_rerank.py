#!/usr/bin/env python3
"""Time the candidate rerank op (row 2 of the kernel table) on the card at
the four shapes its paths give it.

    python3 tools/time_rerank.py [--src DIR] [--label NAME] [--seed S] [--probe]

The options are the card timers' (``tools/_ab.py``): ``--src`` times another
checkout's ``src``, so one command can time two checkouts in turns (parent,
change, change, parent), each in its own process.  The inputs, made on the
card from ``--seed`` (:func:`shapes`):

* ``main``: 64 queries x 4,352 candidates at d = 128 over 1M points, int32
  ids drawn uniformly (the fused query's compaction buffer, as
  ``chip_smoke.py``'s row-2 check draws it);
* ``sharded``: 32 x 3,000 at d = 128 over 1M points (``sharded_serve``'s
  config A: a chunk of 32 queries and its candidates), int32 ids drawn
  uniformly;
* ``dryrun``: 8 x 187,500 at d = 8 over 62.5M points: the ids rank 0's
  share of the 1B x 128 dry-run cell gives the op in its first chunk of 8
  queries (built as ``chip_smoke.py``'s ``dryrun_suco`` phase builds it:
  ``build_sharded`` on a (1, 1) mesh over NCCL at world size 1), and
  ``dryrun_sorted``, the same ids sorted within each query's row;
* ``d64``: 30 x 20,000 at d = 64 over the baselines' 20,000 points:
  ``baselines._common.brute_force``'s call, int64 ids as an expanded
  ``arange`` (a stride-0 view).

Per shape: the device's time a call (``chip_smoke.device_ms``: every kernel
the call launches, the wrapper's own passes included), ``call_ms`` by CUDA
events, the bound (``chip_smoke.rerank_bound``: ids as stored, the queries and
the output read or written once, and each distinct row the ids name read
once), the largest error against the plain version, whether two launches
give equal bits, a fingerprint of the output, and the distinct rows the
ids name.  ``--probe``: the card's rate
for scattered 32-byte reads over the dry-run's 2 GB of points
(``kernel.scattered_read_probe``: at the dry-run row's 1.5M reads and at
16M, 1, 2, 4 and 8 reads a thread in flight; ``--probe-only``: that
alone), in GB/s, and what the dry-run row's 1.5M rows of 32 bytes take at
the best of those rates.  Prints
one JSON line with ``nvidia-smi``'s name and power limit and the tree's
``-Xptxas -v`` lines.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import _ab

REPS = 50  # launches a reading


def dryrun_inputs(chip_smoke, seed: int):
    """``(ids, x, q)`` of the first row-2 call of the dry-run share's query
    of 8."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import Mesh, ShardedSuCoEngine, build_sharded
    from repro_torch.distributed import engine as eng_mod
    from repro_torch.launch.dryrun_suco import SHARE_N, suco_config

    dev = torch.device("cuda", 0)
    cfg = suco_config(n_subspaces=1)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{chip_smoke.free_port()}",
                            rank=0, world_size=1, device_id=dev)
    try:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((SHARE_N, 8), device=dev, generator=g)
        q = torch.randn((256, 8), device=dev, generator=g)
        mesh = Mesh((1, 1), ("data", "model"))
        eng = ShardedSuCoEngine(mesh, cfg, x, build_sharded(mesh, x, cfg, device=dev), device=dev)
        ids, _, q_blk = chip_smoke.first_call(eng_mod, "gather_rerank_block",
                                              lambda: eng.query(q[: cfg.q_chunk]))
        del eng
    finally:
        dist.destroy_process_group()
    return ids, x, q_blk


def shapes(chip_smoke, seed: int) -> dict:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x128 = torch.randn((1_000_000, 128), device=dev, generator=g)
    x64 = torch.randn((20_000, 64), device=dev, generator=g)
    out = {}
    for name, m, c in (("main", 64, 4_352), ("sharded", 32, 3_000)):
        out[name] = (torch.randint(0, x128.shape[0], (m, c), device=dev, generator=g,
                                   dtype=torch.int32),
                     x128, torch.randn((m, 128), device=dev, generator=g))
    ids, x8, q8 = dryrun_inputs(chip_smoke, seed)
    out["dryrun"] = (ids, x8, q8)
    out["dryrun_sorted"] = (ids.sort(dim=1).values, x8, q8)
    out["d64"] = (torch.arange(x64.shape[0], device=dev).expand(30, -1), x64,
                  torch.randn((30, 64), device=dev, generator=g))
    return out


def main() -> int:
    args, chip_smoke, out = _ab.start(__doc__, "time_rerank", {
        "--probe": "also measure the card's rate for scattered 32-byte reads",
        "--probe-only": "measure that rate alone, no shape"})
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_rerank import kernel as gk
    from repro_torch.kernels.gather_rerank import ops
    from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref

    out["shapes"] = {}
    for name, (ids, x, q) in ({} if args.probe_only else shapes(chip_smoke, args.seed)).items():
        first = ops.gather_rerank_block(ids, x, q)
        want = gather_rerank_block_ref(ids.clamp(0, x.shape[0] - 1), x, q)
        bms, by, distinct = chip_smoke.rerank_bound(ids, x, q, first)
        rec = dict(shape=[*ids.shape, x.shape[1]], ids=str(ids.dtype), distinct_rows=distinct,
                   bound_ms=bms, bound_by=by,
                   max_abs_err=float((first - want).abs().max()),
                   within_rtol=bool(((first - want).abs() <= 2e-5 * want.abs()).all()),
                   equal_bits=bool(torch.equal(first, ops.gather_rerank_block(ids, x, q))),
                   fingerprint=chip_smoke.fingerprint(first),
                   **chip_smoke.timed(lambda: ops.gather_rerank_block(ids, x, q), REPS))
        out["shapes"][name] = rec
        del first, want
    if args.probe or args.probe_only:
        x8 = torch.randn((62_500_000, 8), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(args.seed))
        probe = {}
        for reads in (1_500_000, 16_777_216):
            for r in (1, 2, 4, 8):
                ms = chip_smoke.device_ms(lambda: gk.scattered_read_probe(x8, reads, r),
                                          REPS)["ms"]
                probe[f"{reads} reads, {r} a thread"] = dict(ms=ms, gb_per_s=reads * 32 / ms / 1e6)
        best = max(v["gb_per_s"] for k, v in probe.items() if k.startswith("1500000 "))
        probe["dryrun_at_probe_rate_ms"] = 8 * 187_500 * 32 / (best * 1e6)
        out["scattered_read_probe"] = probe
    out["ptxas"] = [ln for name in ("gather_rerank", "read_probe") if name in _build.SOURCES
                    for ln in _build.ptxas_report(name)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
