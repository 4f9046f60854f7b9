#!/usr/bin/env python3
"""Time the chunk-score ops (rows 1, 7 and 8 of the kernel table) on the
card's own clock at the shapes their paths give them, and the query batches
that launch them.

    python3 tools/time_sc_score.py [--src DIR] [--label NAME] [--seed S]
                                   [--batches]

The options are the card timers' (``tools/_ab.py``): ``--src`` times another
checkout's ``src``, so one command can time two checkouts in turns (parent,
change, change, parent), each in its own process.  The inputs are
``chip_smoke.py``'s: ``gaussian_mixture`` at SIFT1M's shape (n = 1M,
d = 128) from ``--seed``, the default SuCo index built on the card, 64
queries (``make_queries``) and their cell ranks and cutoffs
(``cell_score_inputs``: Ns = 8, K = 2,500).  Row 7 (``sc_scores_cells``)
runs at m = 1, 8 and 64 queries over streaming chunks of 4,096 columns,
each launch the next chunk as the streaming query takes them
(``stream_<m>``), over the first chunk again and again (``stream_64_same``:
its cell ids stay in L2) and over all n columns, the dense mode's one
launch (``dense_<m>``); row 8 (``sc_scores_cells_prefilter``) at m = 64
over one fused chunk (``prefilter_64``).  Row 1
(``sc_scores_cells_prefilter_compact``) replays the chunks of one fused
batch of m = 1, 8 and 64 queries in order, each with the arguments the
fused query passed it (``chip_smoke.fused_compact_calls``: ``thr`` -1 on
the first chunk, then the warm pool's minimum): ``compact_<m>`` is one
batch's chunks, ``compact_<m>_first`` the first chunk alone and
``compact_<m>_warm`` the second alone; ``compact_64_table`` is
``chip_smoke.py``'s old table shape (the first chunk again and again at
``thr`` = Ns / 2).

Per shape: ``ms``, the device time of one call (``chip_smoke.device_ms``:
the profiler's kernel time over ``REPS`` calls, the median of 5 readings,
every reading kept), ``call_ms`` (CUDA events around ``REPS`` back-to-back
calls, the median of 5 readings: how fast the host issues the op), the
device events one call launches, whether two launches gave
equal bits, and a fingerprint of the outputs that two trees must share.
With ``--batches``, fused batches of 1, 8 and 64 queries through the
engine (``SuCoEngine.query``, k = 10) and a streaming and a dense batch of
64 (``suco_query``): ``WALL_REPS`` readings on the host clock ending in a
synchronise, and one batch under the profiler (device busy, idle share,
top kernels, the port's kernels).  Prints the tree's ``-Xptxas -v`` lines
for ``csrc/sc_score.cu`` and one JSON line with ``nvidia-smi``'s name and
power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import _ab

REPS = {"stream": 100, "dense": 10, "prefilter": 50, "compact": 10, "chunk": 50}
CHUNK = 4096  # the streaming query's chunk
WALL_REPS = 5  # batches timed on the host clock


def chunk_record(chunks: list[dict], outs: list) -> dict:
    """What the fused batch gave row 1: chunk width, slots, and per chunk
    the threshold's range and the survivor count's mean and most."""
    counts = outs[3::4]
    return dict(chunks=len(chunks), bc=chunks[0]["cells"].shape[1], cap=chunks[0]["cap"],
                thr=[[int(c["thr"].min()), int(c["thr"].max())] for c in chunks],
                count_mean=[float(t.float().mean()) for t in counts],
                count_max=[int(t.max()) for t in counts])


def main() -> int:
    args, chip_smoke, out = _ab.start(__doc__, "time_sc_score", {
        "--batches": "also time fused batches of 1, 8 and 64 and a streaming and a dense batch of 64"})
    import torch

    from repro_torch import EnginePolicy, SuCoEngine
    from repro_torch.core.suco import SuCoConfig, build_index, suco_query
    from repro_torch.data import gaussian_mixture, make_queries
    from repro_torch.kernels import _build
    from repro_torch.kernels.sc_score import ops

    dev = torch.device("cuda")
    x_np = gaussian_mixture(1_000_000, 128, args.seed)
    data = torch.from_numpy(x_np).to(dev)
    q64 = torch.from_numpy(make_queries(x_np, 64, seed=args.seed + 1)).to(dev)
    index = build_index(data, SuCoConfig())
    ranks, cuts = chip_smoke.cell_score_inputs(index, q64)
    cells = index.cell_ids
    engine = SuCoEngine(data, index, EnginePolicy(alpha=0.05, beta=0.02), device=dev)
    fused_chunk = engine.tiles_for(64, 10).block_n
    thr = torch.full((64,), cells.shape[0] // 2, dtype=torch.int32, device=dev)

    chunks = cells.shape[1] // CHUNK
    turn = [0]  # the chunk the next streaming call takes

    def stream(r, c):
        """The next of the index's chunks, in turn, as the streaming query
        launches them."""
        lo = turn[0] % chunks * CHUNK
        turn[0] += 1
        return ops.sc_scores_cells(r, c, cells[:, lo:lo + CHUNK])

    calls = {}
    for m in (1, 8, 64):
        r, c = ranks[:, :m].contiguous(), cuts[:, :m].contiguous()
        calls[f"stream_{m}"] = ("stream", lambda r=r, c=c: stream(r, c))
        calls[f"dense_{m}"] = ("dense", lambda r=r, c=c: ops.sc_scores_cells(r, c, cells))
    calls["stream_64_same"] = ("stream", lambda: ops.sc_scores_cells(ranks, cuts, cells[:, :CHUNK]))
    calls["prefilter_64"] = ("prefilter", lambda: ops.sc_scores_cells_prefilter(
        ranks, cuts, cells[:, :fused_chunk], thr))
    fused = {m: chip_smoke.fused_compact_calls(engine, q64[:m], 10) for m in (1, 8, 64)}

    def replay(chunks):
        """Row 1 over recorded chunks: every output of every chunk, in order."""
        return [t for outs in chip_smoke.replay_compact(chunks) for t in outs]

    for m, rec in fused.items():
        calls[f"compact_{m}"] = ("compact", lambda c=rec: replay(c))
        calls[f"compact_{m}_first"] = ("chunk", lambda c=rec[:1]: replay(c))
        calls[f"compact_{m}_warm"] = ("chunk", lambda c=rec[1:2]: replay(c))
    table = dict(fused[64][0], thr=thr, limit=fused_chunk)
    calls["compact_64_table"] = ("chunk", lambda: replay([table]))

    out.update(n=cells.shape[1], ns=cells.shape[0], cells=ranks.shape[2],
               fused_chunk=fused_chunk, shapes={})
    for name, (kind, fn) in calls.items():
        turn[0] = 0
        first = fn()
        turn[0] = 0  # the same chunk again
        second = fn()
        if isinstance(first, torch.Tensor):
            first, second = (first,), (second,)
        prints = [chip_smoke.fingerprint(t) for t in first]
        if kind == "compact":  # one per output, summed over the chunks
            out["shapes"][f"{name}_chunks"] = chunk_record(fused[int(name[8:])], first)
            prints = [sum(prints[i::4]) for i in range(4)]
        dev_t = chip_smoke.device_ms(fn, REPS[kind])
        calls_t = _ab.readings(chip_smoke, fn, REPS[kind], 5)
        out["shapes"][name] = dict(
            ms=dev_t["ms"], ms_readings=dev_t["readings"],
            events_per_call=dev_t["events_per_call"], events_lost=dev_t["events_lost"],
            retakes=dev_t["retakes"],
            call_ms=calls_t["ms"], call_ms_readings=calls_t["readings"], reps=REPS[kind],
            equal_bits=all(torch.equal(a, b) for a, b in zip(first, second)),
            fingerprint=prints)
        del first, second
    out["ptxas"] = _build.ptxas_report("sc_score")
    if args.batches:
        out["batches"] = {}
        for m in (1, 8, 64):
            def served(m=m):
                return engine.query(q64[:m], 10)

            out["batches"][f"fused_{m}"] = dict(wall_s=_ab.wall(served, WALL_REPS),
                                                profile=chip_smoke.profile_batch(served))
        for mode in ("streaming", "dense"):
            def batch(mode=mode):
                return suco_query(data, index, q64, k=10, alpha=0.05, beta=0.02, mode=mode,
                                  block_n=4096)

            out["batches"][mode] = dict(wall_s=_ab.wall(batch, WALL_REPS),
                                        profile=chip_smoke.profile_batch(batch))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
