"""Time the fused query's batches of 1, 8 and 64 on one tree, in its own
process: the main path of ``chip_smoke.py`` (1M x 128 ``gaussian_mixture``
points, the default ``SuCoConfig``, alpha 0.05, beta 0.02, k = 10), built
and warmed, then each batch size served ``--reps`` times, host clock, each
call ending in a synchronise.

Run two trees in turns to compare them on one card, e.g. the parent commit
unpacked under ``build/parent`` and this checkout::

  python tools/time_fused.py --src build/parent/src --label parent
  python tools/time_fused.py --label change

``--counting`` serves with ``merge_impl="counting"`` (trees that have it).
The last line is one JSON object: the tree's label, ``nvidia-smi``'s name
and power limit, the build seconds, per batch size the median and the
readings in ms, and a fingerprint of the answers (equal fingerprints: equal
ids, distances and scores).
"""

from __future__ import annotations

import json
import statistics
import time

import _ab

REPS = 30


def main() -> None:
    args, chip_smoke, header = _ab.start(__doc__, "time_fused",
                                         {"--counting": "merge with merge_impl='counting'"})
    import torch

    from repro_torch import EnginePolicy, SuCoConfig, SuCoEngine
    from repro_torch.data import gaussian_mixture, make_queries

    x_np = gaussian_mixture(1_000_000, 128, args.seed)
    q64 = torch.from_numpy(make_queries(x_np, 64, seed=args.seed + 1)).cuda()
    data = torch.from_numpy(x_np).cuda()
    kw = dict(merge_impl="counting") if args.counting else {}
    t0 = time.perf_counter()
    engine = SuCoEngine.build(data, SuCoConfig(), policy=EnginePolicy(alpha=0.05, beta=0.02, **kw),
                              device=data.device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine.warmup(batch_sizes=(1, 8, 64), ks=(10,))
    out = dict(header, counting=args.counting, build_seconds=build_s, batches={})
    prints = []
    for m in (1, 8, 64):
        lat, res = chip_smoke.serve_times(lambda m=m: engine.query(q64[:m], 10), reps=REPS)
        out["batches"][str(m)] = dict(median_ms=statistics.median(lat), latency_ms=lat)
        prints += [chip_smoke.fingerprint(t) for t in res]
    out["fingerprint"] = prints
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
