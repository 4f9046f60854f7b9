"""Multi-pod dry-run of the LM stack: one rank's step of every (arch x shape
x mesh) cell on fake tensors (the counterpart of ``repro.launch.dryrun``).

Where the reference lowers and compiles each cell for 256 / 512 fabricated
XLA devices, the port runs rank 0's program itself: ``torch.distributed``'s
``fake`` backend stands in for the 256- (or 512-) rank group, the
production mesh ((16, 16) or (2, 16, 16), :mod:`.mesh`) is a ``DeviceMesh``
of ``cuda`` over it, and the rank's shares of the params, AdamW moments,
batch and cache (:mod:`.shardings`) are tensors on the ``meta`` device
wrapped as ``DTensor``s (``DTensor.from_local``), so no card and no memory
are needed.  The shares are ``meta``, not fake ``cuda`` tensors as in
:mod:`.dryrun_suco`: the model reads ``x.device`` to make its position ids
and masks, which the op recorder must answer with ``meta`` for a fake
``cuda`` tensor on a CPU-only build, and the two then meet in one op.  On
``meta`` tensors row 11 takes its kernel route, whose operator
(``torch.ops.repro_torch.linear_attn``) gives the output shapes.

Per cell, one train step (``make_train_step(remat=True)`` with AdamW),
prefill or decode step runs once under :class:`.op_analysis.OpTally` with
``per_rank=True``: what DTensor runs on this rank's shares (the local ops,
the functional collectives of each redistribution) is tallied.  The JSON
keeps the reference's keys where they have a counterpart:

* ``memory_analysis``: the rank's argument, output and temp bytes (the
  peak of the step's own live bytes, outputs included; an eager step makes
  new params and moments where the reference donates its buffers);
* ``cost_analysis``: the rank's FLOPs (``torch.utils.flop_counter``'s
  formulas on the local shapes, and the kernel operators' own counts) and
  bytes accessed;
* ``collectives``: bytes and counts by kind, every launch counted;
* ``param_count``, ``active_param_count``, ``status``, ``n_chips``.

A decode cell's ``pos`` is its last position (``seq_len - 1``): the port's
decode takes a Python int, and every position reads the whole cache.

``--share`` instead predicts the one-card sharded train step of
``chip_smoke.py``'s ``lm_sharded`` phase (:func:`share_prediction`): the
cell :data:`SHARE_ARCH` x :data:`SHARE_SHAPE` on a :data:`SHARE_MESH` mesh,
whose constants that phase runs.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-1.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --share

Results go to ``build/dryrun/<arch>__<shape>__pod{1,2}<tag>.json`` (the
share's to ``build/dryrun/lm_share.json``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch.dryrun_suco import fake_group
from repro_torch.launch.mesh import MESHES, make_mesh
from repro_torch.launch.op_analysis import OpTally
from repro_torch.models import SHAPES, Model, input_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ShapeSpec
from repro_torch.models.shard_ctx import sharded
from repro_torch.train._tree import leaves
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_step

__all__ = ["should_skip", "run_cell", "run_and_save", "cell_arguments", "share_prediction",
           "RESULTS_DIR", "SHARE_ARCH", "SHARE_SHAPE", "SHARE_MESH"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
DEVICE = torch.device("meta")

#: the one-card cell of ``chip_smoke.py``'s ``lm_sharded`` phase: RWKV6-1.6B
#: at full width, 8 x 2,048 tokens a step, on a (1, 1, 1) mesh
SHARE_ARCH = "rwkv6-1.6b"
SHARE_SHAPE = ShapeSpec("train_8x2048", "train", 2048, 8)
SHARE_MESH = (1, 1, 1)


def _cell_name(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def should_skip(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "long_500k skipped: pure full-attention arch (sub-quadratic rule, "
            "see DESIGN.md §6)"
        )
    return None


def _local(mesh, specs, shapes):
    """This rank's ``meta`` shares of ``shapes`` under ``specs``, and the
    ``DTensor``s of the full shapes over them."""
    shares = SH.spec_tree_map(
        lambda s, x: torch.empty(SH.local_shape(mesh, s, tuple(x.shape)), dtype=x.dtype,
                                 device=DEVICE), specs, shapes)
    return SH.shard_tree(mesh, specs, shares, shapes), shares


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree) if isinstance(t, torch.Tensor))


def _local_tree(tree):
    return {k: _local_tree(v) if isinstance(v, dict) else
            (v.to_local() if hasattr(v, "to_local") else v) for k, v in tree.items()}


def cell_arguments(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """``(args, shares)``: the step's arguments as ``DTensor``s over
    ``meta`` shares, and the shares alone (a dict of trees): ``params`` (fp32
    master), for ``train`` the AdamW ``opt`` state, and the cell's inputs
    (``input_specs``)."""
    model = Model(cfg)
    p_shapes = model.param_shapes()
    params, p_shares = _local(mesh, SH.param_specs(cfg, mesh, p_shapes), p_shapes)
    ins = input_specs(cfg, shape)
    b_specs = SH.batch_specs(cfg, mesh, shape, ins)
    args, shares = {"params": params}, {"params": p_shares}
    if shape.kind == "train":
        o_shapes = {"mu": p_shapes, "nu": p_shapes,
                    "step": torch.empty((), dtype=torch.int32, device="meta")}
        args["opt"], shares["opt"] = _local(mesh, SH.opt_state_specs(cfg, mesh, o_shapes),
                                            o_shapes)
    batch = {k: v for k, v in ins.items() if k != "pos"}
    b_sp = {k: v for k, v in b_specs.items() if k != "pos"}
    args["batch"], shares["batch"] = _local(mesh, b_sp, batch)
    return args, shares


def _step(cfg: ModelConfig, shape: ShapeSpec, mesh, args, act_sharding: bool):
    model = Model(cfg)
    batch = args["batch"]
    if shape.kind == "train":
        step = make_train_step(model, OptConfig(), remat=True, mesh=mesh,
                               act_sharding=act_sharding)
        return step(args["params"], args["opt"], batch)
    with torch.no_grad(), sharded(mesh, act_sharding):
        if shape.kind == "prefill":
            return model.prefill(args["params"], batch["tokens"], extras=batch.get("extras"),
                                 max_seq=shape.seq_len)
        return model.decode_step(args["params"], batch["cache"], batch["token"],
                                 shape.seq_len - 1)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, act_sharding: bool = True,
             cfg: ModelConfig | None = None) -> dict:
    """Rank 0's step of one cell over a fake group -> the JSON record.
    ``cfg`` replaces the arch's config (a cut one, for tests)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    skip = should_skip(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": skip}
    return _run(arch, cfg, shape, multi_pod, act_sharding, MESHES["prod2" if multi_pod else "prod"])


def share_prediction() -> dict:
    """The train step ``chip_smoke.py``'s ``lm_sharded`` phase runs on one
    card (:data:`SHARE_ARCH` x :data:`SHARE_SHAPE`, a world of one rank);
    its record's ``memory_analysis.peak_bytes`` predicts the card's
    ``max_memory_allocated`` over the steps."""
    return _run(SHARE_ARCH, get_config(SHARE_ARCH), SHARE_SHAPE, False, True,
                (SHARE_MESH, ("pod", "data", "model")))


def _run(arch: str, cfg: ModelConfig, shape: ShapeSpec, multi_pod: bool, act_sharding: bool,
         mesh_def: tuple[tuple[int, ...], tuple[str, ...]]) -> dict:
    """One step of ``cfg`` x ``shape`` by rank 0 of a fake group on the mesh
    ``mesh_def`` (its shape and dim names) -> the JSON record."""
    mesh_shape, axes = mesh_def
    world = math.prod(mesh_shape)
    with fake_group(world):
        t0 = time.perf_counter()
        mesh = make_mesh(mesh_shape, axes, "cuda")
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        args, shares = cell_arguments(cfg, shape, mesh)
        with OpTally(leaves(shares), per_rank=True) as tally:
            out = _step(cfg, shape, mesh, args, act_sharding)
            out_bytes = _nbytes(_local_tree(dict(enumerate(out)) if isinstance(out, tuple)
                                            else out))
        t_run = time.perf_counter() - t0
    s = tally.summary()
    n_params = sum(math.prod(x.shape) for x in leaves(Model(cfg).param_shapes()))
    return {
        "arch": arch,
        "shape": shape.name,
        "multi_pod": multi_pod,
        "n_chips": world,
        "status": "ok",
        "mesh_s": round(t_mesh, 4),
        "run_s": round(t_run, 2),
        "memory_analysis": {
            "argument_size_in_bytes": s["argument_bytes"],
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": s["peak_live_bytes"] - s["argument_bytes"],
            "peak_bytes": s["peak_live_bytes"],
        },
        "cost_analysis": {"flops": s["flops"], "bytes_accessed": s["bytes_accessed"],
                          "ops": s["ops"], "kernel_calls": s["kernel_calls"]},
        "collectives": s["collectives"],
        "largest_intermediate": s["largest_intermediate"],
        "act_sharding": act_sharding,
        "param_count": int(n_params),
        "active_param_count": cfg.active_param_count(),
        "mesh": mesh_shape,
    }


def run_and_save(arch: str, shape: str, multi_pod: bool, force: bool,
                 act_sharding: bool = True, tag: str = "", out_dir: Path = RESULTS_DIR) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{_cell_name(arch, shape, multi_pod)}{tag}.json"
    if out.exists() and not force:
        rec = json.loads(out.read_text())
        print(f"[cached] {out.name}: {rec['status']}")
        return rec
    print(f"[dryrun] {arch} x {shape} ({'2 pods' if multi_pod else '1 pod'}) ...", flush=True)
    try:
        rec = run_cell(arch, shape, multi_pod=multi_pod, act_sharding=act_sharding)
    except Exception as e:  # the record says what failed; the exit code too
        rec = {
            "arch": arch, "shape": shape, "multi_pod": multi_pod,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    out.write_text(json.dumps(rec, indent=2))
    extra = ""
    if rec["status"] == "ok":
        extra = (f" run={rec['run_s']}s flops={rec['cost_analysis']['flops']:.3e}"
                 f" coll={rec['collectives']['total_bytes'] / 1e9:.3f}GB")
    print(f"[done]   {out.name}: {rec['status']}{extra}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-act-sharding", action="store_true",
                    help="baseline: drop activation sharding constraints")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR, help="directory of the JSON files")
    ap.add_argument("--share", action="store_true",
                    help="predict chip_smoke.py's lm_sharded step instead (share_prediction)")
    args = ap.parse_args(argv)
    if args.share:
        rec = share_prediction()
        out = args.out / "lm_share.json"
        args.out.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=2))
        print(json.dumps({k: rec[k] for k in ("status", "memory_analysis", "run_s")}), flush=True)
        return 0
    if args.all:
        archs, shapes = ARCH_IDS, tuple(SHAPES)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        archs, shapes = (args.arch,), (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    n_bad = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_and_save(arch, shape, mp, args.force,
                                   act_sharding=not args.no_act_sharding, tag=args.tag,
                                   out_dir=args.out)
                n_bad += rec["status"] == "error"
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
