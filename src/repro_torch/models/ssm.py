"""The sequence-mixing blocks of the attention-free and hybrid families
(the counterpart of ``repro.models.ssm``): RWKV6 ("Finch", data-dependent
per-channel decay) and Mamba2 (SSD, a scalar decay per head), each with its
one-token decode form.  Both reduce to the gated linear-attention
recurrence of :mod:`repro_torch.kernels.linear_attn`: RWKV6 in its ``rwkv``
mode (shift 1 and a bonus), Mamba2 in its ``ssd`` mode (shift 0, no bonus).

The reference's simplifications are kept as they are.  RWKV6: a static
token-shift mix per projection (the low-rank data-dependent mix only for the
decay ``w``), and a per-head RMS "groupnorm" without a scale.  Mamba2: B and
C are shared across heads (as in SSD) and broadcast to ``(B, H, T, N)``, the
depthwise causal conv runs on the value path only, and the step is
``softplus(dt + dt_bias)`` with no further discretisation.

Where each dtype sits, as in the reference.  RWKV6: in the forward and
prefill paths the decay is cast to the compute dtype before the kernel; the
decode path keeps it in fp32.  Mamba2: in the forward and prefill paths the
step ``dtf`` and the decay ``exp(-dtf * exp(a_log))`` are computed in fp32,
then the decay and the ``dtf`` scale of ``v`` are cast to the compute dtype
before the kernel, and ``d_skip * v`` is added in that dtype; the decode
path (``mamba2_decode``) keeps all of the recurrence, the skip included, in
fp32 and casts once before the norm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_attn.ops import linear_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    _sigmoid,
    _silu,
    apply_norm,
    init_linear,
    init_norm,
    linear,
)
from repro_torch.models.shard_ctx import gather_fsdp, splittable

__all__ = [
    "init_rwkv_time_mix", "rwkv_time_mix", "init_rwkv_channel_mix",
    "rwkv_channel_mix", "rwkv_time_mix_decode", "rwkv_channel_mix_decode",
    "init_mamba2", "mamba2_forward", "mamba2_decode",
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
    dd = torch.tanh(mixed(4).float() @ gather_fsdp(p["w_a"])) @ gather_fsdp(p["w_b"])
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
        return splittable(a, -1, h).reshape(b, t, h, hd).transpose(1, 2)

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
    rf, kf, vf = (splittable(a, -1, h).reshape(b, h, hd).float() for a in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]  # (B, H, hd, hd)
    o = torch.einsum("bhk,bhkv->bhv", rf, sf + u[None, :, :, None] * kv)
    new_state = splittable(w, -1, h).reshape(b, h, hd)[..., :, None] * sf + kv
    of = o * torch.rsqrt(torch.mean(o * o, dim=-1, keepdim=True) + 1e-6)
    o = of.to(dtype).reshape(b, d)
    return linear(p["wo"], o * _silu(g), dtype), x, new_state.to(state.dtype)


def rwkv_channel_mix_decode(
    p: Params, x: torch.Tensor, prev_x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    return _channel_mix(p, x, prev_x), x


# ------------------------------- Mamba2 ------------------------------------


def init_mamba2(generator: torch.Generator, cfg: ModelConfig,
                lead: tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = cfg.n_heads
    dev = generator.device
    return {
        "w_in": init_linear(generator, d, 2 * inner + 2 * n + h, lead=lead),  # x, z, B, C, dt
        "conv": torch.randn((*lead, cfg.ssm_conv, inner), generator=generator, device=dev) * 0.1,
        "a_log": torch.zeros((*lead, h), device=dev),
        "dt_bias": torch.zeros((*lead, h), device=dev),
        "d_skip": torch.ones((*lead, h), device=dev),
        "norm": init_norm(cfg, inner, lead=lead, device=dev),
        "w_out": init_linear(generator, inner, d, lead=lead),
    }


def _in_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """``x: (..., D)`` -> ``xin, z (..., inner), B, C (..., N), dt (..., H)``
    in ``x``'s dtype."""
    inner = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    return torch.split(linear(p["w_in"], x, x.dtype), [inner, inner, n, n, cfg.n_heads], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` in its own form."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _step_and_decay(p: Params, dt: torch.Tensor):
    """fp32 ``dtf = softplus(dt + dt_bias)`` and the decay
    ``exp(-dtf * exp(a_log))`` in (0, 1], one per head on ``dt``'s last axis."""
    dtf = _softplus(dt.float() + p["dt_bias"])
    return dtf, torch.exp(-dtf * torch.exp(p["a_log"]))


def _causal_conv(p: Params, xin: torch.Tensor, cfg: ModelConfig):
    """The depthwise causal conv of ``xin: (B, T, inner)`` through SiLU, in
    ``xin``'s dtype, and ``xin`` with the ``K - 1`` zeros of the causal pad
    in front (its last ``K - 1`` rows are the decode's conv state)."""
    t = xin.shape[1]
    kw = p["conv"].to(xin.dtype)  # (K, inner)
    xpad = F.pad(xin, (0, 0, cfg.ssm_conv - 1, 0))
    acc = xpad[:, :t] * kw[0]
    for i in range(1, cfg.ssm_conv):
        acc = acc + xpad[:, i:i + t] * kw[i]
    return _silu(acc), xpad


def _ssd_inputs(p: Params, xconv: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                dt: torch.Tensor, cfg: ModelConfig):
    """The kernel's ``q, k, v, w``, each ``(B, H, T, .)`` in the compute
    dtype: C and B broadcast over the heads, ``v = dtf * xconv`` by head,
    the per-head decay broadcast over N."""
    b, t, inner = xconv.shape
    h, n = cfg.n_heads, cfg.ssm_state
    dtype = xconv.dtype
    dtf, decay = _step_and_decay(p, dt)  # (B, T, H)
    v = splittable(xconv, -1, h).reshape(b, t, h, inner // h).transpose(1, 2)
    v = v * dtf.transpose(1, 2)[..., None].to(dtype)
    k = bmat[:, None].expand(b, h, t, n)
    q = cmat[:, None].expand(b, h, t, n)
    w = decay.transpose(1, 2)[..., None].to(dtype).expand(b, h, t, n)
    return q, k, v, w


def _ssd_out(p: Params, y: torch.Tensor, v: torch.Tensor, z: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The skip, the gated norm and the output projection of the kernel's
    ``y: (B, H, T, P)`` -> ``(B, T, D)``."""
    b, h, t, ph = y.shape
    dtype = z.dtype
    y = y + p["d_skip"].to(dtype)[None, :, None, None] * v
    y = y.transpose(1, 2).reshape(b, t, h * ph)
    y = apply_norm(p["norm"], y, cfg) * _silu(z)
    return linear(p["w_out"], y, dtype)


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x: (B, T, D)`` -> ``(B, T, D)`` through the ``(B, H, T, D)`` entry
    of the linear-attention kernel in ``ssd`` mode."""
    xin, z, bmat, cmat, dt = _in_proj(p, x, cfg)
    xconv, _ = _causal_conv(p, xin, cfg)
    q, k, v, w = _ssd_inputs(p, xconv, bmat, cmat, dt, cfg)
    return _ssd_out(p, linear_attention(q, k, v, w, mode="ssd"), v, z, cfg)


def mamba2_decode(
    p: Params,
    x: torch.Tensor,  # (B, D)
    conv_state: torch.Tensor,  # (B, K-1, inner): the last K-1 raw inputs
    ssm_state: torch.Tensor,  # (B, H, N, P)
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token Mamba2 -> ``(out (B, D), new conv state, new SSD state)``.
    The new conv state is in the dtype the reference's concatenation gives
    (the wider of the state's and ``x``'s); the SSD state keeps its own."""
    dtype = x.dtype
    b = x.shape[0]
    h = cfg.n_heads
    xin, z, bmat, cmat, dt = _in_proj(p, x, cfg)
    inner = xin.shape[-1]
    kw = p["conv"].to(dtype)  # (K, inner)
    wide = torch.promote_types(conv_state.dtype, dtype)
    hist = torch.cat([conv_state.to(wide), xin[:, None].to(wide)], dim=1)  # (B, K, inner)
    xconv = _silu((hist.float() * kw.float()).sum(1).to(wide))

    dtf, decay = _step_and_decay(p, dt)  # (B, H)
    v = splittable(xconv, -1, h).reshape(b, h, inner // h).float() * dtf[..., None]
    sf = ssm_state.float()
    new_s = (decay[..., None, None] * sf
             + bmat.float()[:, None, :, None] * v[:, :, None, :])  # (B, H, N, P)
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), new_s)
    y = y + p["d_skip"][None, :, None] * v
    y = y.reshape(b, inner).to(dtype)
    y = apply_norm(p["norm"], y, cfg) * _silu(z)
    return linear(p["w_out"], y, dtype), hist[:, 1:], new_s.to(ssm_state.dtype)
