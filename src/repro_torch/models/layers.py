"""Shared layers of the LM stack: initialisers, the linear layer, the
norms, RoPE, attention (online softmax over KV chunks, and one-token decode
against a KV cache), the MLPs and the top-k MoE layer with its sort-based
capacity dispatch; the counterpart of ``repro.models.layers``.

Parameters are plain nested dicts of tensors (fp32 master), in the
reference's layout: a linear weight is ``w: (d_in, d_out)`` applied as
``x @ w``, so the reference's weights carry over without a transpose.
Compute runs in the config dtype (bf16 by default) with fp32
normalisation statistics.  Initialisers draw on the device of the
``torch.Generator`` they are given; ``lead`` prefixes the shapes (the
stacked layer axis).

Sharded (``DTensor``s, :mod:`repro_torch.models.shard_ctx`): attention's q
/ k / v / o, the MLP's hidden and the MoE buffers are constrained as the
reference's, and the identity on plain tensors.  Where DTensor's
propagation lacks a rule or would pick a costly layout, an explicit step:
a linear weight is gathered over its fsdp dim at use (``gather_fsdp``); a
norm takes whole rows (``whole_rows``); a head split the mesh does not
divide replicates first (``splittable``); GQA K / V whose heads do not
divide the tensor axis are repeated to the query heads and the softmax
accumulators laid out as the queries (:func:`flash_attention`); the
decode's K / V write at ``pos`` goes to the rank holding it
(:func:`write_seq`), its scores taken with q laid out as the cache; the
MoE routing, dispatch and combine run on each rank's batch rows through
``local_map`` (a stable sort, ``searchsorted``, gathers and scatters).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.shard_ctx import gather_fsdp, splittable, whole_rows
from repro_torch.placements import constrain, dim_sizes, is_dtensor

__all__ = ["Params", "_dense_init", "linear", "init_linear", "init_norm", "apply_norm",
           "cast_linears", "rope", "init_attention", "flash_attention", "attn_forward",
           "attn_decode", "write_seq", "put", "placed_as", "init_mlp", "mlp_forward", "init_moe", "moe_capacity",
           "moe_route", "moe_dispatch", "moe_buffer", "moe_experts", "moe_combine",
           "moe_forward"]

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
    in ``dtype`` returns it as it is, so the values are the same.  A
    ``DTensor`` weight is gathered over its fsdp dim after the cast
    (:func:`~repro_torch.models.shard_ctx.gather_fsdp`)."""
    y = torch.matmul(x, gather_fsdp(p["w"].to(dtype)))
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
    and the MoE layer's expert tensors (``w_gate`` / ``w_up`` / ``w_down``
    leaves; an MLP's are linear layers, dicts) cast to ``dtype`` once;
    every other leaf is the same tensor."""
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = cast_linears(val, dtype)
        elif key in ("w", "w_gate", "w_up", "w_down"):
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
    xf = whole_rows(x).float()
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
    return splittable(x, -1, n_heads).reshape(b, s, n_heads, -1).transpose(1, 2)  # (B, H, S, h)


def _softcap(s: torch.Tensor, cap: float | None, inplace: bool = True) -> torch.Tensor:
    """``cap * tanh(s / cap)``, in place on ``s`` unless autograd needs the
    ``tanh`` (``inplace=False``): the same values either way."""
    if cap is None:
        return s
    if not inplace:
        return torch.tanh(s / cap) * cap
    return s.div_(cap).tanh_().mul_(cap)


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """``q: (B, Hq, Sq, h)`` -> fp32 ``(B, Hkv, G * Sq, h)`` scaled by
    ``1 / sqrt(h)``: query head ``j`` reads KV head ``j // G`` (the
    reference's ``reshape(b, hkv, g, sq, hd)``, i.e. ``repeat_interleave``
    of the KV heads)."""
    b, hq, sq, hd = q.shape
    q = splittable(q, 1, hkv)
    return q.reshape(b, hkv, (hq // hkv) * sq, hd).float() * (1.0 / math.sqrt(hd))


def _kv_heads_as_q(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """A GQA ``DTensor`` K or V whose heads do not divide the mesh dims that
    shard the queries' heads, or whose queries are sharded by sequence,
    repeated to one head per query head (each KV head read by its ``G``
    query heads, as the grouping reads it) and sharded as the queries'
    heads: the grouping would otherwise have to gather the queries' heads
    (every rank of the tensor axis computing all of the attention) or merge
    their sharded sequence into the group dim."""
    from torch.distributed.tensor import Shard

    hq, hkv = q.shape[1], kv.shape[1]
    on = [d for d, p in enumerate(q.placements) if p == Shard(1)]
    n = math.prod(dim_sizes(q.device_mesh)[d] for d in on)
    by_seq = Shard(2) in q.placements  # the queries' sequence sharded (``qseq``)
    if hq == hkv or not (by_seq or on and hkv % n):
        return kv
    b, _, s, hd = kv.shape
    kv = kv[:, :, None].expand(b, hkv, hq // hkv, s, hd).reshape(b, hq, s, hd)
    if not on:
        return kv
    return kv.redistribute(kv.device_mesh, [Shard(1) if d in on else p
                                            for d, p in enumerate(kv.placements)])


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
    skipped.  The score passes run in place unless autograd records a
    gradient of ``q``, ``k`` or ``v``, which needs the softcap's ``tanh`` and
    the masked scores as they were; the values are the same."""
    if is_dtensor(q):
        k, v = _kv_heads_as_q(q, k), _kv_heads_as_q(q, v)
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
    acc = torch.zeros_like(qf)  # (B, Hkv, G*Sq, h) fp32, laid out as the queries
    m = torch.full_like(qf[..., 0], -math.inf)
    lse = torch.zeros_like(m)
    inplace = not (torch.is_grad_enabled()
                   and (q.requires_grad or k.requires_grad or v.requires_grad))
    for ci in range(n_chunks):
        kb = k[:, :, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        vb = v[:, :, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        s = _softcap(qf @ kb.transpose(-1, -2), softcap, inplace)  # (B, Hkv, G*Sq, C)
        kpos = ci * kv_chunk + torch.arange(kv_chunk, device=q.device)
        ok = (kpos[None, :] < skv).expand(sq, kv_chunk)  # the tail padding
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            ok = ok & (qpos[:, None] - kpos[None, :] < window)
        s = s.view(b, hkv, g, sq, kv_chunk).masked_fill_(~ok, -1e30).view(s.shape)
        m_new = torch.maximum(m, s.amax(-1))
        p = s.sub_(m_new[..., None]).exp_() if inplace else torch.exp(s - m_new[..., None])
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
    # heads over the tensor axis when divisible, else sequence parallelism
    q = constrain(q, "batch", ("heads", "qseq"), ("qseq",), None)
    k = constrain(k, "batch", ("kv_heads",), None, None)
    v = constrain(v, "batch", ("kv_heads",), None, None)
    if cfg.use_rope and kv_override is None:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal and kv_override is None, window=window,
                        softcap=cfg.attn_softcap)
    o = constrain(o, "batch", ("heads", "qseq"), ("qseq",), None)
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
    write_seq(cache_k, pos, k1)
    write_seq(cache_v, pos, v1)
    hkv = cfg.n_kv_heads
    qg = _grouped(q, hkv)
    if is_dtensor(cache_k):  # q laid out as the cache, whole over its sequence
        from torch.distributed.tensor import Replicate, Shard

        qg = qg.redistribute(cache_k.device_mesh, [Replicate() if p == Shard(2) else p
                                                   for p in cache_k.placements])
    s = _softcap(qg @ cache_k.float().transpose(-1, -2), cfg.attn_softcap)
    kpos = torch.arange(smax, device=x.device)
    ok = kpos <= pos
    if window is not None:
        ok = ok & (pos - kpos < window)
    w = torch.softmax(s.masked_fill_(~ok, -1e30), dim=-1)  # (B, Hkv, G, Smax)
    o = (w @ cache_v.float()).reshape(b, 1, cfg.q_dim)
    return linear(p["wo"], o.to(dtype), dtype), cache_k, cache_v


def write_seq(cache: torch.Tensor, start: int, new: torch.Tensor) -> None:
    """``cache[:, :, start:start + n] = new`` in place (``new: (B, H, n,
    hd)``).  On a ``DTensor`` cache each rank writes its own share of
    ``new``; where the sequence dim is sharded (a GQA model whose KV heads do
    not divide the tensor axis, or ``long_500k``) each rank writes the part
    of ``[start, start + n)`` its block holds (DTensor has no rule for an
    in-place write into part of a sharded dim)."""
    n = new.shape[2]
    if not is_dtensor(cache):
        if n == 1:  # one decode step's token
            cache[:, :, start] = new[:, :, 0]
        else:
            cache[:, :, start:start + n] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    want = [Replicate() if p == Shard(2) else p for p in cache.placements]
    local_new = new.redistribute(mesh, want).to_local()
    coord, sizes = mesh.get_coordinate(), dim_sizes(mesh)
    blocks, i = 1, 0
    for d, p in enumerate(cache.placements):
        if p == Shard(2):
            blocks, i = blocks * sizes[d], i * sizes[d] + coord[d]
    size = cache.shape[2] // blocks
    lo, hi = max(start, i * size), min(start + n, (i + 1) * size)
    if lo < hi:
        cache.to_local()[:, :, lo - i * size:hi - i * size] = local_new[:, :, lo - start:hi - start]


def placed_as(new: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A decode step's new state laid out as the cache entry it replaces (a
    ``DTensor``'s placements; a partial sum reduced), so a sharded cache
    keeps its specs step after step; a plain tensor as it is."""
    if not is_dtensor(new) or tuple(new.placements) == tuple(like.placements):
        return new
    return new.redistribute(like.device_mesh, like.placements)


def put(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[...] = src`` in place; a ``DTensor`` ``src`` is first moved to
    ``dst``'s placements (an in-place copy cannot change them)."""
    if is_dtensor(dst):
        dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())
    else:
        dst[...] = src


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
        gate = constrain(linear(p["w_gate"], x, dtype), "batch", None, "ffn")
        act = _silu(gate) if cfg.mlp == "swiglu" else _gelu(gate)
        up = constrain(linear(p["w_up"], x, dtype), "batch", None, "ffn")
        return linear(p["w_down"], act * up, dtype)
    h = constrain(linear(p["w_up"], x, dtype), "batch", None, "ffn")
    return linear(p["w_down"], _gelu(h), dtype)


# --------------------------------- MoE --------------------------------------


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             lead: tuple[int, ...] = ()) -> Params:
    """The router (a linear ``D -> E``) and each expert's SwiGLU, fp32:
    ``w_gate`` / ``w_up`` ``(E, D, F)`` at ``1 / sqrt(D)``, ``w_down``
    ``(E, F, D)`` at ``1 / sqrt(F)``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return torch.randn((*lead, *shape), generator=generator,
                           device=generator.device).mul_(scale)

    return {
        "router": init_linear(generator, d, e, lead=lead),
        "w_gate": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_up": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f)),
    }


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """The slots each expert has in one batch row of a call over ``s``
    tokens, from shapes alone: ``ceil(k * s / E * capacity_factor)`` (320 for
    OLMoE's prefill of 2,048 tokens, 1 for a decode step)."""
    return int(math.ceil(cfg.top_k_experts * s / cfg.n_experts * cfg.capacity_factor))


def moe_route(p: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``x: (B, S, D)`` -> each token's top ``k`` experts ``(B, S, k)`` (int64)
    and their weights (fp32, renormalised to sum to 1).  The router runs in
    ``x``'s dtype, its softmax in fp32; the top ``k`` come from a stable
    descending sort, so equal probabilities go to the lower expert, as
    ``jax.lax.top_k`` breaks ties (``torch.topk`` promises no order among
    them)."""
    probs = torch.softmax(linear(p["router"], x, x.dtype).float(), dim=-1)
    return _top_k(probs, cfg.top_k_experts)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    top_p, top_e = probs.sort(dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), top_e


def moe_dispatch(top_e: torch.Tensor, n_experts: int,
                 cap: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's per-row capacity dispatch, for all rows at once.

    A row's ``S * k`` (token, expert) pairs are sorted stably by expert, so
    an expert's pairs stand in token order; a pair's place among its
    expert's (its sorted position less the expert's first, the exclusive
    cumsum of the expert counts) is its slot, and a pair keeps it where it
    is below ``cap``.  Returns ``token (B, E, C)``, the token each slot
    holds; ``filled (B, E, C)``; and ``slot (B, S, k)``, each pair's slot in
    ``top_e``'s order, ``cap`` or more where the pair drops."""
    b, s, k = top_e.shape
    dev = top_e.device
    e_sorted, order = top_e.reshape(b, s * k).sort(dim=-1, stable=True)
    experts = torch.arange(n_experts, device=dev).expand(b, n_experts).contiguous()
    starts = torch.searchsorted(e_sorted, experts)  # the exclusive cumsum of the counts
    counts = torch.searchsorted(e_sorted, experts, right=True) - starts
    c = torch.arange(cap, device=dev)
    at = (starts[:, :, None] + c).clamp_(max=s * k - 1).view(b, n_experts * cap)
    token = (order.gather(1, at) // k).view(b, n_experts, cap)
    filled = c < counts[:, :, None]
    in_e = torch.arange(s * k, device=dev) - starts.gather(1, e_sorted)
    slot = torch.empty_like(in_e).scatter_(1, order, in_e)  # back to (token, k) order
    return token, filled, slot.view(b, s, k)


def moe_buffer(x: torch.Tensor, token: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """The experts' input ``(E, B * C, D)``, row-major in (expert, row,
    slot): each filled slot's token of ``x: (B, S, D)``, zero where the slot
    is unfilled."""
    b, s, d = x.shape
    e, cap = token.shape[1:]
    rows = (token + (torch.arange(b, device=x.device) * s)[:, None, None]).transpose(0, 1)
    h = x.reshape(b * s, d)[rows.reshape(-1)].view(e, b * cap, d)
    return h.masked_fill_(~filled.transpose(0, 1).reshape(e, b * cap, 1), 0)


def moe_experts(p: Params, h: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows, ``h: (E, N, D) -> (E, N, D)``,
    as batched products over the experts in ``h``'s dtype: fp32
    accumulation, one rounding.

    Sharded, the expert dim takes the tensor axis past 16 experts (the
    reference's expert-parallel layout, which this batched layout is), and
    the rows the batch axes; below that the reference loops over the
    experts with tokens batch-sharded and ``d_ff`` tensor-parallel, which
    here is the same constraint without the expert dim."""
    dtype = h.dtype
    ex = ("expert",) if h.shape[0] > 16 else None
    h = constrain(h, ex, ("batch",), None)
    gate = constrain(torch.bmm(h, gather_fsdp(p["w_gate"].to(dtype))), ex, ("batch",), "ffn")
    up = constrain(torch.bmm(h, gather_fsdp(p["w_up"].to(dtype))), ex, ("batch",), "ffn")
    out = torch.bmm(_silu(gate) * up, gather_fsdp(p["w_down"].to(dtype)))
    return constrain(out, ex, ("batch",), None)


def moe_combine(out: torch.Tensor, top_p: torch.Tensor, top_e: torch.Tensor,
                slot: torch.Tensor, cap: int) -> torch.Tensor:
    """``out: (E, B * C, D)`` back to the tokens, ``(B, S, D)``: a token's
    kept outputs, each times its weight in ``out``'s dtype, added into zeros
    in ascending expert order with a rounding at each add, the order in
    which the reference's ``.at[tok_sorted].add`` applies them (its pairs
    stand in expert order).  A gather and an add a step of ``k``, no atomic
    add, so the bits do not change from run to run."""
    b, s, k = top_e.shape
    e_asc, perm = top_e.sort(dim=-1)
    slot, w = slot.gather(2, perm), top_p.gather(2, perm).to(out.dtype)
    keep = slot < cap
    at = (e_asc * b + torch.arange(b, device=out.device)[:, None, None]) * cap
    at = at + slot.clamp(max=cap - 1)
    out = out.reshape(-1, out.shape[-1])
    y = out.new_zeros((b, s, out.shape[-1]))
    for j in range(k):
        y = y + torch.where(keep[..., j, None], out[at[..., j]], 0) * w[..., j, None]
    return y


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE with the reference's sort-based capacity dispatch
    (GShard-style dropping), batched over the rows with tensor ops and
    nothing read back to the host: :func:`moe_route`, :func:`moe_dispatch`
    at the call's capacity (:func:`moe_capacity`), :func:`moe_buffer`,
    :func:`moe_experts`, :func:`moe_combine`.

    The reference has two layouts of the experts' products, expert-major
    for E > 16 and a loop over the experts below that, for TPU sharding;
    both compute what the one batched layout here computes.

    On ``DTensor``s the routing, the dispatch and the combine (a stable
    sort, ``searchsorted``, gathers and scatters, which DTensor has no rules
    for) run on each rank's batch rows through ``local_map``; the experts'
    products are DTensor ops."""
    cap = moe_capacity(cfg, x.shape[1])
    if is_dtensor(x):
        return _moe_forward_sharded(p, x, cfg, cap)
    top_p, top_e = moe_route(p, x, cfg)
    token, filled, slot = moe_dispatch(top_e, cfg.n_experts, cap)
    out = moe_experts(p, moe_buffer(x, token, filled))
    return moe_combine(out, top_p, top_e, slot, cap)


def _moe_forward_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig, cap: int) -> torch.Tensor:
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    x = constrain(x, "batch", None, None)
    probs = torch.softmax(linear(p["router"], x, x.dtype).float(), dim=-1)
    mesh, rows = x.device_mesh, tuple(x.placements)
    if any(isinstance(q, Shard) and q.dim != 0 for q in rows):
        raise ValueError(f"the MoE layer needs its tokens sharded on the batch dim, got {rows}")
    slots = tuple(Shard(1) if isinstance(q, Shard) else q for q in rows)

    def dispatch(x_l, probs_l):
        top_p, top_e = _top_k(probs_l, cfg.top_k_experts)
        token, filled, slot = moe_dispatch(top_e, cfg.n_experts, cap)
        return moe_buffer(x_l, token, filled), top_p, top_e, slot

    h, top_p, top_e, slot = local_map(dispatch, out_placements=(slots, rows, rows, rows),
                                      in_placements=(rows, rows), device_mesh=mesh,
                                      redistribute_inputs=True)(x, probs.redistribute(mesh, rows))
    out = moe_experts(p, h)
    combine = local_map(lambda o, tp, te, sl: (moe_combine(o, tp, te, sl, cap),),
                        out_placements=(rows,), in_placements=(slots, rows, rows, rows),
                        device_mesh=mesh, redistribute_inputs=True)
    return combine(out, top_p, top_e, slot)[0]
