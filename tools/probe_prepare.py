#!/usr/bin/env python3
"""Where the serving thread's time goes while a re-index prepares beside it.

    python3 tools/probe_prepare.py [--src DIR] [--label NAME] [--seed S]

The options are the card timers' (``tools/_ab.py``).  The stack is
``chip_smoke.py``'s ``mutable_serve`` one: the default SuCo index over
``gaussian_mixture`` at n = 1M, d = 128, a mutable engine of capacity 1.2M
under a 2-level ladder warmed at batches 1-16, ``AnnServer``,
``MutationManager`` and a group-commit ``Durability`` root, 25 inserts of
4,000 rows and a delete of 50,000 keys.  Then, once at each Python thread
switch interval of ``SWITCH_MS`` (the stack built anew each time from the
same index and rows): 24 ``steady_b8`` bursts, ``reindex_async``, bursts
until the prepare is done, ``finish_reindex``.  Meanwhile a sampler thread
wakes every 1 ms and records the innermost frame of the prepare thread and
of the serving thread, and how late it woke (a wake-up later than 3 ms
means another thread held the GIL that long).

Per interval, one JSON line: the bursts' p50 / p99 before and during the
prepare, the prepare's seconds, ``reindex_async``'s return time, the late
wake-ups (count, total, largest) and the prepare thread's frames sampled
during them, and the frames of each thread most often sampled during the
prepare.  Needs a CUDA card.
"""

from __future__ import annotations

import collections
import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import _ab

SWITCH_MS = (5.0, 0.5)  # CPython's default interval, and a tenth of it
LATE_MS = 3.0  # a sampler wake-up this late means the GIL was held elsewhere


def frame_label(frame) -> str:
    """``file:function:line`` of the innermost frame in this repository, else
    of the innermost frame."""
    inner = frame
    while frame is not None:
        name = frame.f_code.co_filename
        if "repro_torch" in name or "chip_smoke" in name:
            inner = frame
            break
        frame = frame.f_back
    code = inner.f_code
    return f"{Path(code.co_filename).name}:{code.co_name}:{inner.f_lineno}"


class Sampler(threading.Thread):
    """Every 1 ms: the innermost frames of the watched threads, and how late
    this thread woke."""

    def __init__(self):
        super().__init__(name="prepare-probe", daemon=True)
        self.watch: dict[str, int] = {}
        self.samples: list[tuple[float, float, dict[str, str]]] = []
        self.stop = threading.Event()

    def run(self):
        due = time.perf_counter()
        while not self.stop.is_set():
            now = time.perf_counter()
            frames = sys._current_frames()
            labels = {who: frame_label(frames[tid]) for who, tid in self.watch.items()
                      if tid in frames}
            self.samples.append((now, (now - due) * 1e3, labels))
            due = now + 1e-3
            time.sleep(1e-3)


def main() -> int:
    args, cs, header = _ab.start(__doc__, "probe_prepare")
    import numpy as np
    import torch

    from repro_torch import SuCoConfig, SuCoEngine, build_index, EnginePolicy
    from repro_torch.data import gaussian_mixture, make_queries
    from repro_torch.serve import (AnnServer, DegradationLadder, Durability, DurabilityConfig,
                                   MutationManager)

    dev = torch.device("cuda")
    n, d, k = 1_000_000, 128, 10
    x_np = gaussian_mixture(n, d, args.seed)
    data = torch.from_numpy(x_np).to(dev)
    index = build_index(data, SuCoConfig())
    policy = EnginePolicy(alpha=0.05, beta=0.02)
    pool = make_queries(x_np, 1024, seed=args.seed + 30)
    new = gaussian_mixture(cs.MUTABLE_INSERTS * cs.MUTABLE_INSERT_ROWS, d, args.seed + 4)
    for switch_ms in SWITCH_MS:
        sys.setswitchinterval(switch_ms / 1e3)
        rng = np.random.default_rng(args.seed + 31)
        root = Path(tempfile.mkdtemp(prefix="suco-probe-"))
        try:
            eng = SuCoEngine(data, index, policy, capacity=cs.MUTABLE_CAPACITY, device=dev)
            ladder = DegradationLadder(eng, levels=2)
            ladder.warmup(batch_sizes=range(1, cs.SERVE_MAX_BATCH + 1), ks=(k,))
            server = AnnServer(eng, max_batch=cs.SERVE_MAX_BATCH, ladder=ladder)
            mgr = MutationManager(server, SuCoConfig())
            dur = Durability(root, DurabilityConfig(fsync="group")).attach(server, mgr)
            keys = np.concatenate([mgr.insert(new[i:i + cs.MUTABLE_INSERT_ROWS])
                                   for i in range(0, len(new), cs.MUTABLE_INSERT_ROWS)])
            del_rng = np.random.default_rng(args.seed + 32)
            mgr.delete(np.concatenate([
                del_rng.choice(n, cs.MUTABLE_DELETES // 2, replace=False),
                del_rng.choice(keys, cs.MUTABLE_DELETES // 2, replace=False)]))
            rid = 0
            before = []
            for _ in range(24):
                before += cs.serve_burst(server, pool, rng, rid, 8, k)
                rid += 8
            sampler = Sampler()
            sampler.watch = {"prepare": dur.worker._thread.ident,
                             "serving": threading.main_thread().ident}
            torch.cuda.synchronize()
            sampler.start()
            t0 = time.perf_counter()
            job = mgr.reindex_async()
            t_return = time.perf_counter()
            during = []
            while not job.done:
                during += cs.serve_burst(server, pool, rng, rid, 8, k)
                rid += 8
            t_done = time.perf_counter()
            sampler.stop.set()
            sampler.join()
            mgr.finish_reindex(timeout=600)
            dur.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        window = [s for s in sampler.samples if t0 <= s[0] <= t_done]
        late = [s for s in window if s[1] > LATE_MS]
        top = {who: collections.Counter(s[2].get(who, "-") for s in window).most_common(8)
               for who in ("prepare", "serving")}
        late_frames = collections.Counter(s[2].get("prepare", "-") for s in late).most_common(8)
        print(json.dumps(dict(
            **header, switch_ms=switch_ms, before=cs.latencies(before),
            during=cs.latencies(during), bursts_during=len(during) // 8,
            prepare_s=job._result.prepare_s, prepare_wall_s=t_done - t0,
            reindex_async_return_ms=(t_return - t0) * 1e3,
            gather_ms=job._gathered.gather_s * 1e3,
            samples=len(window), late=dict(count=len(late),
                                           total_ms=float(sum(s[1] for s in late)),
                                           max_ms=float(max((s[1] for s in late), default=0.0)),
                                           prepare_frames=late_frames),
            top_frames=top)), flush=True)
        del eng, ladder, server, mgr, dur, job
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
