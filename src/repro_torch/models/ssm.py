"""RWKV6 ("Finch", data-dependent per-channel decay): the time mix, whose
sequence mixing is the gated linear-attention recurrence of
:mod:`repro_torch.kernels.linear_attn`, the channel mix, and their one-token
decode forms.  The RWKV6 half of ``repro.models.ssm``; Mamba2 is not ported
yet.

The reference's simplifications are kept as they are: a static token-shift
mix per projection (the low-rank data-dependent mix only for the decay
``w``), and a per-head RMS "groupnorm" without a scale.  In the forward and
prefill paths the decay is cast to the compute dtype before the kernel; the
decode path keeps it in fp32, as the reference does in both places.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_attn.ops import linear_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _sigmoid, _silu, init_linear, linear

__all__ = [
    "init_rwkv_time_mix", "rwkv_time_mix", "init_rwkv_channel_mix",
    "rwkv_channel_mix", "rwkv_time_mix_decode", "rwkv_channel_mix_decode",
]


def init_rwkv_time_mix(generator: torch.Generator, cfg: ModelConfig,
                       lead: tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    lora = 64
    dev = generator.device

    def normal(*shape):
        return torch.randn((*lead, *shape), generator=generator, device=dev)

    return {
        "mu": torch.full((*lead, 5, d), 0.5, device=dev),  # shift-mix for r,k,v,g,w
        "wr": init_linear(generator, d, d, lead=lead),
        "wk": init_linear(generator, d, d, lead=lead),
        "wv": init_linear(generator, d, d, lead=lead),
        "wg": init_linear(generator, d, d, lead=lead),
        "wo": init_linear(generator, d, d, lead=lead),
        "w0": torch.full((*lead, d), -6.0, device=dev),  # base decay (w ~ exp(-exp(.)))
        "w_a": normal(d, lora) * 0.01,
        "w_b": normal(lora, d) * 0.01,
        "u": normal(d) * 0.1,  # bonus
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _projections(p: Params, x: torch.Tensor, prev: torch.Tensor):
    """r, k, v, g in ``x``'s dtype and the decay ``w`` in fp32, from the
    token-shift mixes of ``x`` with ``prev``."""
    dtype = x.dtype

    def mixed(i):
        return x + (prev - x) * p["mu"][i].to(dtype)

    r = linear(p["wr"], mixed(0), dtype)
    k = linear(p["wk"], mixed(1), dtype)
    v = linear(p["wv"], mixed(2), dtype)
    g = linear(p["wg"], mixed(3), dtype)
    # data-dependent decay (the Finch contribution)
    dd = torch.tanh(mixed(4).float() @ p["w_a"]) @ p["w_b"]
    w = torch.exp(-torch.exp(p["w0"] + dd))  # in (0, 1)
    return r, k, v, g, w


def _group_norm_out(p: Params, o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-head RMS groupnorm of ``o: (B, H, T, hd)``, then the gated output
    projection -> ``(B, T, D)``."""
    b, h, t, hd = o.shape
    dtype = g.dtype
    of = o.float()
    of = of * torch.rsqrt(torch.mean(of * of, dim=-1, keepdim=True) + 1e-6)
    o = of.to(dtype).transpose(1, 2).reshape(b, t, h * hd)
    return linear(p["wo"], o * _silu(g), dtype)


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x: (B, T, D)`` -> ``(B, T, D)`` through the ``(B, H, T, hd)``
    entry of the linear-attention kernel."""
    b, t, d = x.shape
    h = cfg.n_heads
    hd = d // h
    r, k, v, g, w = _projections(p, x, _token_shift(x))

    def heads(a):
        return a.reshape(b, t, h, hd).transpose(1, 2)

    o = linear_attention(heads(r), heads(k), heads(v), heads(w.to(x.dtype)),
                         u=p["u"].reshape(h, hd).to(x.dtype), mode="rwkv")
    return _group_norm_out(p, o, g)


def init_rwkv_channel_mix(generator: torch.Generator, cfg: ModelConfig,
                          lead: tuple[int, ...] = ()) -> Params:
    return {
        "mu": torch.full((*lead, 2, cfg.d_model), 0.5, device=generator.device),
        "wr": init_linear(generator, cfg.d_model, cfg.d_model, lead=lead),
        "wk": init_linear(generator, cfg.d_model, cfg.d_ff, lead=lead),
        "wv": init_linear(generator, cfg.d_ff, cfg.d_model, lead=lead),
    }


def _channel_mix(p: Params, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    xk = x + (prev - x) * p["mu"][0].to(dtype)
    xr = x + (prev - x) * p["mu"][1].to(dtype)
    r = _sigmoid(linear(p["wr"], xr, dtype))
    k = torch.square(torch.relu(linear(p["wk"], xk, dtype)))
    return r * linear(p["wv"], k, dtype)


def rwkv_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _channel_mix(p, x, _token_shift(x))


# --------------------------- decode (stateful) ------------------------------


def rwkv_time_mix_decode(
    p: Params, x: torch.Tensor, prev_x: torch.Tensor, state: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token RWKV6 time mix.  ``x: (B, D)``; ``state: (B, H, hd, hd)``
    -> ``(out (B, D), x, new state)``.  The decay stays in fp32."""
    dtype = x.dtype
    b, d = x.shape
    h = cfg.n_heads
    hd = d // h
    r, k, v, g, w = _projections(p, x, prev_x)
    u = p["u"].reshape(h, hd)
    sf = state.float()
    rf, kf, vf = (a.reshape(b, h, hd).float() for a in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]  # (B, H, hd, hd)
    o = torch.einsum("bhk,bhkv->bhv", rf, sf + u[None, :, :, None] * kv)
    new_state = w.reshape(b, h, hd)[..., :, None] * sf + kv
    of = o * torch.rsqrt(torch.mean(o * o, dim=-1, keepdim=True) + 1e-6)
    o = of.to(dtype).reshape(b, d)
    return linear(p["wo"], o * _silu(g), dtype), x, new_state.to(state.dtype)


def rwkv_channel_mix_decode(
    p: Params, x: torch.Tensor, prev_x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    return _channel_mix(p, x, prev_x), x
