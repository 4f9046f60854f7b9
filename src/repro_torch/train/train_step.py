"""Train step factory (the counterpart of ``repro.train.train_step``): loss
-> gradients -> AdamW, with optional gradient accumulation over
micro-batches.  Gradients come from ``torch.autograd.grad`` on leaves
detached from the caller's tree, so a step reads its arguments and
returns new trees, as the reference's step does."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model
from repro_torch.models.shard_ctx import sharded
from repro_torch.placements import is_dtensor
from repro_torch.train._tree import items, leaves
from repro_torch.train.optimizer import OptConfig, apply_gradients

__all__ = ["make_train_step", "make_eval_step", "loss_and_grads"]


def _unflatten(tree: dict, flat: dict[str, torch.Tensor], prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = _unflatten(val, flat, path) if isinstance(val, dict) else flat[path]
    return out


def loss_and_grads(model: Model, params: dict, batch: dict, *,
                   remat: bool = True) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)``: the loss as a detached fp32 0-dim tensor and a
    tree of gradients shaped as ``params`` (zeros for a leaf the loss does
    not reach, as ``jax.grad`` gives)."""
    paths = [path for path, _ in items(params)]
    live = {path: leaf.detach().requires_grad_() for path, leaf in items(params)}
    loss = model.loss(_unflatten(params, live), batch, remat=remat)
    grads = torch.autograd.grad(loss, [live[p] for p in paths], allow_unused=True,
                                materialize_grads=True)
    grads = [_like(g, live[p]) for p, g in zip(paths, grads)]
    return loss.detach(), _unflatten(params, dict(zip(paths, grads)))


def _like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient in its parameter's placements: a replicated
    parameter's gradient comes out of the batch-sharded backward as a
    partial sum over the shards, which this reduces (an all-reduce)."""
    if not is_dtensor(grad) or tuple(grad.placements) == tuple(param.placements):
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def make_train_step(
    model: Model,
    opt_cfg: OptConfig,
    *,
    micro_steps: int = 1,
    remat: bool = True,
    mesh=None,
    act_sharding: bool = True,
) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as
    device tensors (the step reads nothing to the host).

    With a ``mesh`` (:mod:`repro_torch.launch.mesh`) the step takes
    ``DTensor`` params, AdamW moments and batch (:mod:`repro_torch.launch.
    shardings`) and runs in :func:`repro_torch.models.shard_ctx.sharded`
    (the logical activation rules unless ``act_sharding=False``); the new
    params and moments keep their placements.

    With ``micro_steps > 1`` the batch is split along axis 0 and the
    micro-batches' ``loss / micro_steps`` and ``grads / micro_steps`` are
    added, in order, into fp32 zeros, as the reference's scan does: memory
    scales with the micro-batch, the operations are unchanged."""

    def step(params, opt_state, batch):
        if micro_steps == 1:
            loss, grads = loss_and_grads(model, params, batch, remat=remat)
        else:
            micro = {k: v.reshape(micro_steps, v.shape[0] // micro_steps, *v.shape[1:])
                     for k, v in batch.items()}
            dev = leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = None
            for i in range(micro_steps):
                loss_mb, g = loss_and_grads(model, params, {k: v[i] for k, v in micro.items()},
                                            remat=remat)
                loss = loss + loss_mb / micro_steps
                flat_g = dict(items(g))
                if grads is None:
                    grads = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                             for p, t in flat_g.items()}
                grads = {p: grads[p] + flat_g[p] / micro_steps for p in grads}
            grads = _unflatten(params, grads)
        new_params, new_state, metrics = apply_gradients(params, grads, opt_state, opt_cfg)
        return new_params, new_state, dict(metrics, loss=loss)

    if mesh is None:
        return step

    def sharded_step(params, opt_state, batch):
        with sharded(mesh, act_sharding):
            return step(params, opt_state, batch)

    return sharded_step


def make_eval_step(model: Model, *, remat: bool = False) -> Callable:
    """Returns ``step(params, batch) -> loss`` with no gradient recorded."""

    @torch.no_grad()
    def step(params, batch):
        return model.loss(params, batch, remat=remat)

    return step
