"""Training launcher (the counterpart of ``repro.launch.train``): synthetic-data
LM training with checkpoint / restart, straggler monitoring and optional
micro-batching, on one card (``--device cuda``, the default) or the CPU.

CPU-scale usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen1.5-4b \\
      --reduced --steps 100 --global-batch 8 --seq-len 128 --ckpt-dir /tmp/ckpt

RWKV6-1.6B at full width on one H100:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b --full \\
      --global-batch 8 --seq-len 2048 --steps 10

Sharded (``--mesh debug|prod|prod2``, the meshes of :mod:`.mesh`: (2, 2, 2),
(16, 16), (2, 16, 16)): under ``torchrun`` with as many processes as the
mesh has ranks, each rank draws the same fp32 master from ``--seed``, keeps
its share (:mod:`.shardings`, ``DTensor``) and runs the sharded step
(``make_train_step(mesh=...)``); the process group is NCCL on the card and
gloo on the CPU.  A world size other than the mesh's raises before any
step, naming the world the mesh needs (the reference's launcher does not
read ``--mesh``).  ``--ckpt-dir`` is refused with a mesh: the checkpoints
hold whole tensors.

  torchrun --nproc-per-node 8 -m repro_torch.launch.train --device cpu --mesh debug \
      --arch rwkv6-1.6b --reduced --steps 2 --global-batch 8 --seq-len 64

The ``audio`` and ``vlm``
families need ``extras`` (frame or patch embeddings) that the synthetic
data does not give, so the launcher refuses them before any step (the
reference's launcher fails inside its first step).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as SH
from repro_torch.models import Model
from repro_torch.models.backbone import require_extras
from repro_torch.models.model import ShapeSpec
from repro_torch.placements import is_dtensor
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.resilience import FailureInjector, StepTimer
from repro_torch.train.train_step import make_train_step

MESHES = ("none", *mesh_lib.MESHES)


def world_size() -> int:
    """The run's world size: the process group's, else ``torchrun``'s
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_mesh(name: str) -> tuple[tuple[int, ...], tuple[str, ...]] | None:
    """``(shape, axes)`` of ``--mesh name`` (``None`` for ``none``); raises
    unless the world has as many ranks as the mesh."""
    if name == "none":
        return None
    shape, axes = mesh_lib.MESHES[name]
    need, world = math.prod(shape), world_size()
    if world != need:
        raise ValueError(f"--mesh {name} {dict(zip(axes, shape))} needs a world of {need} ranks "
                         f"(torchrun --nproc-per-node {need}); this run has {world}")
    return shape, axes


def make_run_mesh(args):
    """The ``--mesh`` as a ``DeviceMesh`` over a process group made here
    if none is (``torchrun``'s environment), or ``None``."""
    spec = check_mesh(args.mesh)
    if spec is None:
        return None
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir with --mesh: the checkpoints hold whole tensors")
    dev = torch.device(args.device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return mesh_lib.make_mesh(*spec, device_type=dev.type)


def build(args, mesh=None):
    """``(cfg, model, step_fn, data)`` from the parsed arguments; raises
    for a ``--mesh`` the world does not match and for a family that needs
    ``extras``; ``mesh`` (:func:`make_run_mesh`) makes the step sharded."""
    check_mesh(args.mesh)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, d_ff=args.d_model * 4,
            head_dim=args.d_model // cfg.n_heads,
        )
    require_extras(cfg, None)
    model = Model(cfg)
    step_fn = make_train_step(model, opt_config(args), micro_steps=args.micro_steps,
                              remat=not args.no_remat, mesh=mesh)
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, args.seq_len, args.global_batch,
                                    seed=args.seed))
    return cfg, model, step_fn, data


def opt_config(args) -> OptConfig:
    """The schedule: a warmup of a twentieth of the steps (at least 5), then
    cosine decay to the last step."""
    return OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5), total_steps=args.steps)


def batch_on(batch_np: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}


def init_state(model: Model, args, device, mesh=None) -> tuple[int, dict, dict]:
    """``(start_step, params, opt_state)``: restored from the newest
    checkpoint under ``--ckpt-dir`` (templates from ``Model.param_shapes``,
    nothing allocated for them), else fresh from ``--seed``; with a
    ``mesh``, this rank's shares as ``DTensor``s."""
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        p_like = model.param_shapes()
        o_like = init_opt_state(p_like)
        start_step, params, opt_state, _ = CKPT.restore(
            args.ckpt_dir, params_like=p_like, opt_state_like=o_like, device=device)
        print(f"[train] resumed from step {start_step}")
        return start_step, params, opt_state
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    if mesh is not None:
        params = SH.distribute_tree(mesh, SH.param_specs(model.cfg, mesh, params), params)
    return 0, params, init_opt_state(params)


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(t: torch.Tensor) -> float:
    return float(t.full_tensor() if is_dtensor(t) else t)


def train_once(args, injector: FailureInjector | None = None) -> int:
    device = torch.device(args.device)
    mesh = make_run_mesh(args)
    cfg, model, step_fn, data = build(args, mesh)
    start_step, params, opt_state = init_state(model, args, device, mesh)
    shape = ShapeSpec("train", "train", args.seq_len, args.global_batch)

    timer = StepTimer()
    losses = []
    for step in range(start_step, args.steps):
        if injector is not None:
            injector.maybe_fail(step)
        batch = batch_on(data.batch_at(step), device)
        if mesh is not None:
            batch = SH.distribute_tree(mesh, SH.batch_specs(cfg, mesh, shape, batch), batch)
        timer.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = _host(metrics["loss"])
        dt = timer.stop()
        losses.append(loss)
        if (step % args.log_every == 0 or step == args.steps - 1) and _rank0():
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {_host(metrics['grad_norm']):8.3f} {dt*1e3:7.1f} ms"
                  + (" [straggler]" if timer.is_straggler(dt) else ""))
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            CKPT.save(args.ckpt_dir, step + 1, params=params, opt_state=opt_state,
                      extra={"loss": loss}, blocking=False)
    if args.ckpt_dir:
        CKPT.save(args.ckpt_dir, args.steps, params=params, opt_state=opt_state,
                  extra={"loss": losses[-1] if losses else None}, blocking=True)
    if losses and _rank0():
        print(f"[train] done. first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return args.steps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="synthetic-data LM training")
    ap.add_argument("--arch", default="qwen1.5-4b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="none", choices=MESHES)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: list[str] | None = None) -> None:
    try:
        train_once(parser().parse_args(argv))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
