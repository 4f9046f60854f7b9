"""AdamW, the learning-rate schedule and global-norm clipping over a tree
of tensors (the counterpart of ``repro.train.optimizer``), in plain tensor
ops over the leaves with the reference's arithmetic: the clip scale
``min(1, clip / max(gn, 1e-9))``, bias corrections from the step as fp32,
weight decay on leaves of two or more dimensions only, ``mu`` / ``nu`` of
the parameters' own dtype (fp32 for the fp32 master), and each update
computed in fp32 and cast back to the parameter's dtype.  Every value stays
on the parameters' device: nothing is read to the host.

``torch.optim.AdamW`` clips and schedules differently, so it is not used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.train._tree import leaves, tree_map

Params = Any

__all__ = ["OptConfig", "init_opt_state", "apply_gradients", "lr_at", "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * lr``, as fp32."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Params) -> dict:
    """``mu`` and ``nu`` zeros like each parameter, and the step, an int32
    0-dim tensor on the first leaf's device."""
    first = leaves(params)[0]
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: Params) -> torch.Tensor:
    """``sqrt`` of the sum of every leaf's squares in fp32, the leaves added
    in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


@torch.no_grad()
def apply_gradients(params: Params, grads: Params, state: dict,
                    cfg: OptConfig) -> tuple[Params, dict, dict]:
    """One AdamW step -> ``(params, state, metrics)``, new trees (the
    arguments are not written); ``metrics`` holds ``grad_norm`` and ``lr``
    as device tensors."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu2 = cfg.b1 * mu + (1 - cfg.b1) * g
        nu2 = cfg.b2 * nu + (1 - cfg.b2) * g * g
        delta = (mu2 / b1c) / (torch.sqrt(nu2 / b2c) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu2, nu2

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_p, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, {"mu": mu, "nu": nu, "step": step}, {"grad_norm": gn, "lr": lr}
