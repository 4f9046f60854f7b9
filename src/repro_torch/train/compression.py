"""Gradient compression for the data-parallel all-reduce (the counterpart
of ``repro.train.compression``, over ``torch.distributed``).

``int8_allreduce``: per-shard symmetric int8 quantisation, an all-gather
of (payload, scale) and a local dequantise-and-sum.  Bytes on the wire:
n / 4 per hop against an fp32 ring all-reduce's ~2n.  Combine with
:class:`ErrorFeedback` so quantisation error is re-injected next step
(EF-SGD).  A ``group`` (``None``: the default process group) stands where
the reference names a mesh axis; NCCL carries it on the card, gloo on the
CPU.  ``torch.round``, like ``jnp.round``, rounds half to even, so payloads
and scales are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.train._tree import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "int8_allreduce", "ErrorFeedback",
           "compressed_grad_allreduce"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(P, *t.shape)``: every rank's ``t`` in rank order."""
    flat = t.reshape(-1).contiguous()
    out = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, flat, group=group)
    return torch.stack(out).reshape(len(out), *t.shape)


def _mean_of(q: torch.Tensor, s: torch.Tensor, group) -> torch.Tensor:
    qg = _all_gather(q, group)  # (P, ...) int8
    sg = _all_gather(s, group)  # (P,)
    n = qg.shape[0]
    return torch.sum(qg.float() * sg.reshape((n,) + (1,) * q.dim()), dim=0) / n


def int8_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over ``group`` with int8 payloads."""
    q, s = quantize_int8(x)
    return _mean_of(q, s, group)


def compressed_grad_allreduce(grads: Any, group, residuals: Any) -> tuple[Any, Any]:
    """Error-feedback int8 all-reduce over a gradient tree -> ``(means in
    each gradient's dtype, new residuals)``; every rank walks the leaves in
    the same (sorted-key) order."""

    def one(g, r):
        gf = g.float() + r
        q, s = quantize_int8(gf)
        new_r = gf - dequantize_int8(q, s)  # error feedback
        return _mean_of(q, s, group).to(g.dtype), new_r

    out = tree_map(one, grads, residuals)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


class ErrorFeedback:
    """Residual initialiser for :func:`compressed_grad_allreduce`."""

    @staticmethod
    def init(grads_like: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                        grads_like)
