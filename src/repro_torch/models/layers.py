"""Shared layers of the LM stack: initialisers, the linear layer, the
norms, RoPE, attention (online softmax over KV chunks, and one-token decode
against a KV cache) and the MLPs; the counterpart of
``repro.models.layers``, whose MoE layer is not ported yet (ROADMAP queue 1).

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
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

__all__ = ["Params", "_dense_init", "linear", "init_linear", "init_norm", "apply_norm",
           "cast_linears", "rope", "init_attention", "flash_attention", "attn_forward",
           "attn_decode", "init_mlp", "mlp_forward"]

Params = dict


def _dense_init(
    generator: torch.Generator, d_in: int, d_out: int, scale: float | None = None,
    lead: tuple[int, ...] = (),
) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((*lead, d_in, d_out), generator=generator,
                       device=generator.device).mul_(scale)


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


# ----------------------- elementwise, in x's dtype -------------------------


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as a 0-dim CPU tensor (a scalar
    to an op on any device): the reference's Python constants are weakly
    typed and round to a bf16 operand's dtype before the op, where a Python
    float in a PyTorch op would stay fp32."""
    return torch.tensor(value, dtype=like.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` one step at a time in ``x``'s dtype: the
    reference's ``jax.nn.sigmoid``, so a bf16 value rounds where the
    reference's does (``torch.sigmoid`` rounds once and differs from it on a
    third of bf16 inputs)."""
    return 1 / (1 + torch.exp(-x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid(x)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, one step at a time
    in ``x``'s dtype (``torch.nn.functional.gelu`` defaults to the erf form,
    4e-4 away on [-4, 4])."""
    cube = x * x * x
    inner = _scalar(math.sqrt(2 / math.pi), x) * (x + _scalar(0.044715, x) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


# -------------------------------- RoPE -------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """``x: (..., S, h), positions: (S,)`` rotary embedding of the halves
    ``x[..., :h/2]`` against ``x[..., h/2:]`` (not interleaved pairs), with
    fp32 angles; ``x1 * cos`` promotes a bf16 ``x`` to fp32 before the cast
    back."""
    h = x.shape[-1]
    freqs = theta ** (-torch.arange(0, h, 2, dtype=torch.float32, device=x.device) / h)
    ang = positions[..., :, None].float() * freqs  # (S, h/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : h // 2], x[..., h // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ----------------------------- attention -----------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig, kv_heads: int | None = None,
                   lead: tuple[int, ...] = ()) -> Params:
    kv = kv_heads or cfg.n_kv_heads
    return {
        "wq": init_linear(generator, cfg.d_model, cfg.q_dim, cfg.qkv_bias, lead),
        "wk": init_linear(generator, cfg.d_model, kv * cfg.head_dim, cfg.qkv_bias, lead),
        "wv": init_linear(generator, cfg.d_model, kv * cfg.head_dim, cfg.qkv_bias, lead),
        "wo": init_linear(generator, cfg.q_dim, cfg.d_model, lead=lead),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)  # (B, H, S, h)


def _softcap(s: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``cap * tanh(s / cap)``, in place on ``s``."""
    if cap is None:
        return s
    return s.div_(cap).tanh_().mul_(cap)


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """``q: (B, Hq, Sq, h)`` -> fp32 ``(B, Hkv, G * Sq, h)`` scaled by
    ``1 / sqrt(h)``: query head ``j`` reads KV head ``j // G`` (the
    reference's ``reshape(b, hkv, g, sq, hd)``, i.e. ``repeat_interleave``
    of the KV heads)."""
    b, hq, sq, hd = q.shape
    return q.reshape(b, hkv, (hq // hkv) * sq, hd).float() * (1.0 / math.sqrt(hd))


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, h)
    k: torch.Tensor,  # (B, Hkv, Skv, h)
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk`` (memory
    O(Sq * chunk)); GQA by grouping the query heads over the KV heads.

    As the reference: q is cast to fp32, then scaled; scores, statistics and
    P.V are fp32; the softcap comes before the mask, and masked scores
    (past the causal or ``window`` bound, or in the zero padding of the last
    chunk) are -1e30, not -inf.  ``window=None`` masks nothing (the
    reference's ``1 << 30``).  Every chunk is computed and masked; none is
    skipped."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = _grouped(q, hkv)
    kv_chunk = min(kv_chunk, skv)
    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    qpos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros((b, hkv, g * sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g * sq), -math.inf, dtype=torch.float32, device=q.device)
    lse = torch.zeros_like(m)
    for ci in range(n_chunks):
        kb = k[:, :, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        vb = v[:, :, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        s = _softcap(qf @ kb.transpose(-1, -2), softcap)  # (B, Hkv, G*Sq, C)
        kpos = ci * kv_chunk + torch.arange(kv_chunk, device=q.device)
        ok = (kpos[None, :] < skv).expand(sq, kv_chunk)  # the tail padding
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            ok = ok & (qpos[:, None] - kpos[None, :] < window)
        s = s.view(b, hkv, g, sq, kv_chunk).masked_fill_(~ok, -1e30).view(s.shape)
        m_new = torch.maximum(m, s.amax(-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        lse = lse * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp(lse[..., None], min=1e-30)
    return out.reshape(b, hq, sq, hd).to(q.dtype)


def attn_forward(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    causal: bool = True,
    window: int | None = None,
    kv_override: torch.Tensor | None = None,  # cross-attention memory (B, Skv, D)
) -> torch.Tensor:
    dtype = x.dtype
    b, s, _ = x.shape
    src = kv_override if kv_override is not None else x
    q = _split_heads(linear(p["wq"], x, dtype), cfg.n_heads)
    k = _split_heads(linear(p["wk"], src, dtype), cfg.n_kv_heads)
    v = _split_heads(linear(p["wv"], src, dtype), cfg.n_kv_heads)
    if cfg.use_rope and kv_override is None:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal and kv_override is None, window=window,
                        softcap=cfg.attn_softcap)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return linear(p["wo"], o, dtype)


def attn_decode(
    p: Params,
    x: torch.Tensor,  # (B, 1, D)
    cache_k: torch.Tensor,  # (B, Hkv, Smax, h), written in place at pos
    cache_v: torch.Tensor,
    pos: int,
    cfg: ModelConfig,
    *,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a KV cache -> ``(out (B, 1, D), cache_k,
    cache_v)``.

    The new token's K (after RoPE) and V are written **in place** into
    ``cache_k`` / ``cache_v`` at ``pos`` (the reference's
    ``dynamic_update_slice`` under its server's buffer donation), and the
    same tensors are returned.  The softmax runs in fp32 over all ``Smax``
    positions of the cache, read upcast to fp32, with ``kpos <= pos`` and
    the window as the mask."""
    dtype = x.dtype
    b = x.shape[0]
    smax = cache_k.shape[2]
    q = _split_heads(linear(p["wq"], x, dtype), cfg.n_heads)  # (B, Hq, 1, h)
    k1 = _split_heads(linear(p["wk"], x, dtype), cfg.n_kv_heads)
    v1 = _split_heads(linear(p["wv"], x, dtype), cfg.n_kv_heads)
    if cfg.use_rope:
        posv = torch.full((1,), pos, device=x.device)
        q = rope(q, posv, cfg.rope_theta)
        k1 = rope(k1, posv, cfg.rope_theta)
    cache_k[:, :, pos] = k1[:, :, 0]
    cache_v[:, :, pos] = v1[:, :, 0]
    hkv = cfg.n_kv_heads
    s = _softcap(_grouped(q, hkv) @ cache_k.float().transpose(-1, -2), cfg.attn_softcap)
    kpos = torch.arange(smax, device=x.device)
    ok = kpos <= pos
    if window is not None:
        ok = ok & (pos - kpos < window)
    w = torch.softmax(s.masked_fill_(~ok, -1e30), dim=-1)  # (B, Hkv, G, Smax)
    o = (w @ cache_v.float()).reshape(b, 1, cfg.q_dim)
    return linear(p["wo"], o.to(dtype), dtype), cache_k, cache_v


# -------------------------------- MLPs -------------------------------------


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             lead: tuple[int, ...] = ()) -> Params:
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": init_linear(generator, cfg.d_model, cfg.d_ff, lead=lead),
            "w_up": init_linear(generator, cfg.d_model, cfg.d_ff, lead=lead),
            "w_down": init_linear(generator, cfg.d_ff, cfg.d_model, lead=lead),
        }
    return {
        "w_up": init_linear(generator, cfg.d_model, cfg.d_ff, bias=True, lead=lead),
        "w_down": init_linear(generator, cfg.d_ff, cfg.d_model, bias=True, lead=lead),
    }


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU, GeGLU (tanh GELU) or the biased GELU MLP, in ``x``'s dtype."""
    dtype = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        gate = linear(p["w_gate"], x, dtype)
        act = _silu(gate) if cfg.mlp == "swiglu" else _gelu(gate)
        return linear(p["w_down"], act * linear(p["w_up"], x, dtype), dtype)
    return linear(p["w_down"], _gelu(linear(p["w_up"], x, dtype)), dtype)
