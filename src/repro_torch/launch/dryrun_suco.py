"""Dry-run of the sharded SuCo engine at production scale: 1B x 128-d points
on the (2 x) 16 x 16 mesh, the counterpart of the JAX package's
``launch/dryrun_suco.py``, on fake tensors.

Where the reference lowers the sharded query for 256 / 512 fabricated XLA
devices, the port runs rank 0's program itself: ``torch.distributed``'s
``fake`` backend stands in for the 256- (or 512-) rank group, and the
rank's shares are ``FakeTensorMode`` tensors on ``cuda``, so no card and
no memory are needed.  The query step is the one a live engine would
dispatch a 256-query batch to (``ShardedSuCoEngine.aot_query_fn``), run
once under :class:`repro_torch.launch.op_analysis.OpTally`; the blocks are
planned against the H100's static limits (``tuning_backend="h100"``).  Per
extra ``--ks`` value, the ``ShardedEnginePool`` binding is made (its step
and padded batch), not run, as the reference only lowers it.

The cell is the reference's: 256 queries a batch, Ns = 16, sqrt_k = 64,
10 Lloyd steps, alpha 0.03, beta 0.003, k = 50, q_chunk 8.  The JSON keeps
the reference's keys where they have a counterpart: ``tiling``, ``pool``,
``memory_analysis`` (argument / output / temp bytes of the rank),
``cost_analysis``, ``collectives``, ``config``, ``status``.

``--share`` instead predicts the program ``chip_smoke.py``'s
``dryrun_suco`` phase runs on one card: rank 0's share at pod1 (62,500,000
x 8 points, one subspace) on a (1, 1) mesh, ``build_sharded`` then a batch
of 8 and one of 256 at k = 50; its ``peak_bytes`` is the prediction of the
card's ``max_memory_allocated`` over the phase.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun_suco [--multi-pod] [--both-meshes]
      [--ks 10 ...] [--n N] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun_suco --share [--n N] [--output FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed.compat import Mesh
from repro_torch.distributed.engine import (
    DistSuCoConfig,
    ShardedEnginePool,
    ShardedSuCoEngine,
    build_sharded,
    index_shardings,
    resolved_query_block_n,
)
from repro_torch.launch.op_analysis import OpTally

__all__ = ["N_POINTS", "DIM", "N_QUERIES", "suco_config", "suco_cell", "share_prediction",
           "RESULTS_DIR"]

N_POINTS = 1_000_000_000
DIM = 128
N_QUERIES = 256
SHARE_N = N_POINTS // 16  # rank 0's points at pod1
RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def suco_config(*, multi_pod: bool = False, n_subspaces: int = 16) -> DistSuCoConfig:
    """The reference's dry-run cell (``repro/launch/dryrun_suco.py``)."""
    return DistSuCoConfig(
        n_subspaces=n_subspaces, sqrt_k=64, kmeans_iters=10, alpha=0.03, beta=0.003, k=50,
        q_chunk=8, point_axes=("pod", "data") if multi_pod else ("data",),
        tuning_backend="h100",
    )


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A ``fake`` process group of ``world`` ranks, this process rank
    ``rank``: collectives return at once and write nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


def _shares(mesh: Mesh, cfg: DistSuCoConfig, n: int, d: int, mq: int):
    """This rank's argument shares of the query step, as fake tensors."""
    sh = index_shardings(mesh, cfg, n, d)
    n_loc = sh["x"][0].stop - sh["x"][0].start
    ns_loc = sh["cell_ids"][0].stop - sh["cell_ids"][0].start
    d_loc = sh["x"][1].stop - sh["x"][1].start
    h1 = (d // cfg.n_subspaces + 1) // 2
    return (
        _fake((n_loc, d_loc)),
        _fake((ns_loc, cfg.sqrt_k, h1)),
        _fake((ns_loc, cfg.sqrt_k, h1)),
        _fake((ns_loc, n_loc), torch.int32),
        _fake((ns_loc, cfg.n_cells), torch.int32),
        _fake((mq, d_loc)),
    )


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def suco_cell(*, multi_pod: bool, pool_ks: tuple[int, ...] = (10,), n: int = N_POINTS) -> dict:
    """Rank 0's query step of the 1B x 128 cell over a fake 256- (512-)
    rank group -> the JSON record."""
    world = 512 if multi_pod else 256
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    cfg = suco_config(multi_pod=multi_pod)
    with fake_group(world):
        t0 = time.perf_counter()
        mesh = Mesh(shape, names)
        t_mesh = time.perf_counter() - t0
        qfn, mq = ShardedSuCoEngine.aot_query_fn(mesh, cfg, n, DIM, N_QUERIES)
        t0 = time.perf_counter()
        with FakeTensorMode():
            args = _shares(mesh, cfg, n, DIM, mq)
            flops = FlopCounterMode(display=False)
            with flops, OpTally(args, flop_counter=flops) as tally:
                ids, dists = qfn(*args)
            out_bytes = _nbytes(ids, dists)
        t_run = time.perf_counter() - t0
        pool_rec = []
        for k in pool_ks:
            t0 = time.perf_counter()
            _, pmq = ShardedEnginePool.aot_query_fn(mesh, cfg, n, DIM, N_QUERIES, k)
            pool_rec.append({"k": int(k), "mq": int(pmq),
                             "make_s": round(time.perf_counter() - t0, 4)})
        block_n = resolved_query_block_n(mesh, cfg, n, DIM)
    s = tally.summary()
    return {
        "pool": pool_rec,
        "tiling": {"query_block_n": block_n, "q_chunk": cfg.q_chunk,
                   "tuning_backend": cfg.tuning_backend},
        "arch": "suco-engine-1b",
        "shape": "serve_q256",
        "multi_pod": multi_pod,
        "n_chips": world,
        "status": "ok",
        "mesh_s": round(t_mesh, 4),
        "run_s": round(t_run, 2),
        "memory_analysis": {
            "argument_size_in_bytes": s["argument_bytes"],
            "output_size_in_bytes": out_bytes,
            # the peak of the step's own live bytes, outputs included
            "temp_size_in_bytes": s["peak_live_bytes"] - s["argument_bytes"],
        },
        "cost_analysis": {"flops": s["flops"], "bytes_accessed": s["bytes_accessed"],
                          "ops": s["ops"], "kernel_calls": s["kernel_calls"]},
        "collectives": s["collectives"],
        "largest_intermediate": s["largest_intermediate"],
        "config": {"n": n, "d": DIM, "Ns": cfg.n_subspaces, "sqrtK": cfg.sqrt_k,
                   "alpha": cfg.alpha, "beta": cfg.beta, "k": cfg.k, "queries": N_QUERIES,
                   "world": world, "mesh": dict(zip(names, shape))},
    }


def share_prediction(n: int = SHARE_N, d: int = 8, batches: tuple[int, ...] = (8, 256)) -> dict:
    """The one-card program of rank 0's share on fake tensors: a (1, 1) mesh
    (no process group: every collective the identity, as at world size 1),
    ``build_sharded`` of ``n`` x ``d`` points with one subspace, an engine
    over it and one batch of each size at k = 50.  Returns the peak of live
    bytes (the points included) and the program's kernel calls, bytes and
    kernel operations (the ATen products are not counted: their counter
    would add a fifth to a run of some minutes)."""
    cfg = suco_config(n_subspaces=1)
    mesh = Mesh((1, 1), ("data", "model"))
    t0 = time.perf_counter()
    with FakeTensorMode():
        x = _fake((n, d))
        with OpTally((x,)) as tally:
            index = build_sharded(mesh, x, cfg, device=x.device)
            build_peak = tally.peak_live_bytes
            eng = ShardedSuCoEngine(mesh, cfg, x, index, device=x.device)
            for m in batches:
                eng.query(_fake((m, d)))
    s = tally.summary()
    return {
        "status": "ok",
        "n": n, "d": d, "batches": list(batches), "k": cfg.k,
        "query_block_n": resolved_query_block_n(mesh, cfg, n, d),
        "peak_bytes": s["peak_live_bytes"],
        "build_peak_bytes": build_peak,
        "argument_bytes": s["argument_bytes"],
        "run_s": round(time.perf_counter() - t0, 2),
        "cost_analysis": {"kernel_flops": s["flops"], "bytes_accessed": s["bytes_accessed"],
                          "ops": s["ops"], "kernel_calls": s["kernel_calls"]},
        "largest_intermediate": s["largest_intermediate"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--ks", type=int, nargs="*", default=[10],
                    help="extra per-k pool bindings to make (besides cfg.k)")
    ap.add_argument("--n", type=int, default=None, help="points (default: 1B; --share: 62.5M)")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR, help="directory of the JSON files")
    ap.add_argument("--share", action="store_true",
                    help="predict the one-card program of rank 0's share instead")
    ap.add_argument("--output", type=Path, default=None, help="--share: the JSON file")
    args = ap.parse_args(argv)
    if args.share:
        rec = share_prediction(n=args.n or SHARE_N)
        out = args.output or args.out / "share.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=2))
        print(json.dumps(rec), flush=True)
        return 0
    args.out.mkdir(parents=True, exist_ok=True)
    ok = True
    for mp in ((False, True) if args.both_meshes else (args.multi_pod,)):
        out = args.out / f"suco-engine-1b__serve_q256__{'pod2' if mp else 'pod1'}.json"
        print(f"[dryrun] suco engine 1B x 128d ({'2 pods' if mp else '1 pod'}) ...", flush=True)
        try:
            rec = suco_cell(multi_pod=mp, pool_ks=tuple(args.ks), n=args.n or N_POINTS)
        except Exception as e:  # the record says what failed; the exit code too
            ok = False
            rec = {"arch": "suco-engine-1b", "shape": "serve_q256", "multi_pod": mp,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        out.write_text(json.dumps(rec, indent=2))
        print(f"[done]   {out}: {rec['status']}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
