"""Shared layers of the LM stack: initialisers, the linear layer and the
norms (the part of ``repro.models.layers`` the RWKV6 path needs;
attention, RoPE, MLP and MoE are not ported yet).

Parameters are plain nested dicts of tensors (fp32 master), in the
reference's layout: a linear weight is ``w: (d_in, d_out)`` applied as
``x @ w``, so the reference's weights carry over without a transpose.
Compute runs in the config dtype (bf16 by default) with fp32
normalisation statistics.  Initialisers draw on the device of the
``torch.Generator`` they are given; ``lead`` prefixes the shapes (the
stacked layer axis).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["Params", "_dense_init", "linear", "init_linear", "init_norm", "apply_norm",
           "cast_linears"]

Params = dict


def _dense_init(
    generator: torch.Generator, d_in: int, d_out: int, scale: float | None = None,
    lead: tuple[int, ...] = (),
) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((*lead, d_in, d_out), generator=generator,
                       device=generator.device) * scale


def linear(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w (+ b)`` in ``dtype``: fp32 accumulation, one rounding, as the
    reference's ``einsum(..., preferred_element_type=f32).astype(dtype)``.

    The reference casts the fp32 master weight to ``dtype`` on every call.
    The port casts once instead (:func:`cast_linears`, when a model is
    prepared for serving) and keeps that copy; ``.to`` of a weight already
    in ``dtype`` returns it as it is, so the values are the same."""
    y = torch.matmul(x, p["w"].to(dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def init_linear(
    generator: torch.Generator, d_in: int, d_out: int, bias: bool = False,
    lead: tuple[int, ...] = (),
) -> Params:
    p = {"w": _dense_init(generator, d_in, d_out, lead=lead)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), device=generator.device)
    return p


def cast_linears(params: Params, dtype: torch.dtype) -> Params:
    """The same tree with every linear layer's weight (a dict's ``"w"``)
    cast to ``dtype`` once; every other leaf is the same tensor."""
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = cast_linears(val, dtype)
        elif key == "w":
            out[key] = val.to(dtype)
        else:
            out[key] = val
    return out


# ------------------------------- norms ------------------------------------


def init_norm(
    cfg: ModelConfig, d: int | None = None, *, lead: tuple[int, ...] = (),
    device: torch.device | str = "cuda",
) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((*lead, d), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    return y.to(x.dtype)
