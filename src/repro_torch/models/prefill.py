"""Prefill: the full-sequence forward pass that also builds the decode
cache, for every family (the counterpart of ``repro.models.prefill``).

Returns ``(last-token logits, cache)`` with the cache laid out as
:func:`repro_torch.models.decode.init_cache`: for ``dense`` and ``moe``, ``k`` / ``v``
``(L, B, Hkv, max_seq, hd)`` in the cache dtype, keys after RoPE, zero past
the prompt; for ``ssm``, ``prev1`` / ``prev2`` (the last normalised input of
each layer's two mixes) in the cache dtype and ``wkv`` (the linear-attention
state) in fp32; for ``hybrid``, ``conv`` (each Mamba2 layer's last ``K - 1``
raw conv inputs) in the cache dtype, ``ssm`` (the SSD state) in fp32, and
``sk`` / ``sv`` ``(n_apps, B, Hkv, max_seq, hd)``, the shared block's K
(after RoPE) and V at each of its applications, zero past the prompt; for
``audio`` and ``vlm``, ``k`` / ``v`` of the self-attention layers as for
``dense`` (``vlm``: row ``u * (period - 1) + j`` holds unit ``u``'s ``j``-th
dense layer) and ``xk`` / ``xv`` ``(n_cross, B, Hkv, memory, hd)``, the
memory's K and V (no RoPE) in the cache dtype, one row per cross layer:
Whisper's ``n_layers`` over the encoder's output, Llama-3.2-Vision's
``n_layers // period`` over the patch embeddings.  Prefill's own
cross-attention uses those K / V in the compute dtype, as the reference's
does; it computes them once where the reference computes them twice (for
the cache and in ``attn_forward``), the same values.

Where the port differs from the reference on purpose: for a prompt shorter
than ``K - 1`` tokens the reference keeps ``xin[:, t - (K-1):]``, whose
start is then negative, so its conv state has fewer than ``K - 1`` rows and
its next decode step fails.  The port's conv state is the last ``K - 1``
rows of the input with the forward pass's causal pad in front: zeros before
the first token, what that decode step's conv must read.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.linear_attn.ops import linear_attention_with_state
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.backbone import (
    _dtype,
    _layer_windows,
    check_family,
    embed,
    encode,
    ffn_forward,
    gated,
    layer_params,
    logits_for_position,
    require_extras,
    shared_application,
    vlm_self_layer,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import init_cache
from repro_torch.models.layers import Params
from repro_torch.models.shard_ctx import current_mesh, mergeable, splittable
from repro_torch.placements import constrain, is_dtensor

__all__ = ["prefill", "new_cache"]


def new_cache(cfg: ModelConfig, b: int, max_seq: int, dtype: torch.dtype,
              like: torch.Tensor) -> Params:
    """:func:`~repro_torch.models.decode.init_cache` on ``like``'s device; for
    a ``DTensor`` ``like``, ``DTensor`` zeros sharded as the reference's
    ``cache_specs`` fitted to the cache (the mesh of the active
    :func:`~repro_torch.models.shard_ctx.sharded` context)."""
    if not is_dtensor(like):
        return init_cache(cfg, b, max_seq, dtype, like.device)
    from repro_torch.launch.shardings import cache_specs, fit_tree, zeros_tree
    from repro_torch.models.model import ShapeSpec

    mesh = current_mesh()
    if mesh is None:
        raise ValueError("a sharded prefill runs in shard_ctx.sharded(mesh)")
    shapes = init_cache(cfg, b, max_seq, dtype, "meta")
    specs = fit_tree(cache_specs(cfg, mesh, ShapeSpec("prefill", "decode", max_seq, b)),
                     shapes, mesh)
    return zeros_tree(mesh, specs, shapes, like.to_local().device)


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S)
    *,
    extras: torch.Tensor | None = None,
    max_seq: int | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, Params]:
    """``extras`` are the ``audio`` family's frame embeddings ``(B,
    encoder_seq, D)`` or the ``vlm`` family's patch embeddings ``(B,
    vision_tokens, D)``, required there (``ValueError`` without them) and
    unused by the others.  ``max_seq`` (the prompt's length by default)
    sizes the self-attention KV caches; the ``ssm`` state does not grow with
    the sequence and ignores it."""
    check_family(cfg)
    require_extras(cfg, extras)
    x = embed(cfg, params, tokens)
    max_seq = max_seq or tokens.shape[1]
    if cfg.family in ("dense", "moe"):
        x, cache = _dense_prefill(cfg, params, x, max_seq, cache_dtype)
    elif cfg.family == "ssm":
        x, cache = _rwkv_prefill(cfg, params, x, cache_dtype)
    elif cfg.family == "hybrid":
        x, cache = _hybrid_prefill(cfg, params, x, max_seq, cache_dtype)
    elif cfg.family == "audio":
        x, cache = _audio_prefill(cfg, params, x, extras, max_seq, cache_dtype)
    else:
        x, cache = _vlm_prefill(cfg, params, x, extras, max_seq, cache_dtype)
    x_last = L.apply_norm(params["final_norm"], x[:, -1:], cfg)[:, 0]
    return logits_for_position(cfg, params, x_last), cache


def _rwkv_prefill(cfg: ModelConfig, params: Params, x: torch.Tensor,
                  cache_dtype: torch.dtype) -> tuple[torch.Tensor, Params]:
    prev1, prev2, wkv = [], [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        xn1 = L.apply_norm(p["ln1"], x, cfg)
        h, state = _rwkv_time_mix_with_state(p["time_mix"], xn1, cfg)
        x = x + h
        xn2 = L.apply_norm(p["ln2"], x, cfg)
        x = x + S.rwkv_channel_mix(p["channel_mix"], xn2, cfg)
        prev1.append(xn1[:, -1].to(cache_dtype))
        prev2.append(xn2[:, -1].to(cache_dtype))
        wkv.append(state)
    return x, {"prev1": torch.stack(prev1), "prev2": torch.stack(prev2), "wkv": torch.stack(wkv)}


def _rwkv_time_mix_with_state(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """:func:`repro_torch.models.ssm.rwkv_time_mix` that also returns the
    final state ``(B, H, hd, hd)`` f32, through the ``(BH, T, hd)`` entry of
    the linear-attention kernel."""
    b, t, d = x.shape
    h = cfg.n_heads
    hd = d // h
    r, k, v, g, w = S._projections(p, x, S._token_shift(x))

    def heads(a):
        a = mergeable(splittable(a, -1, h).reshape(b, t, h, hd).transpose(1, 2), 1)
        return a.reshape(b * h, t, hd).contiguous()

    u_b = p["u"].reshape(1, h, hd).to(x.dtype).expand(b, h, hd).reshape(b * h, 1, hd)
    u_b = u_b.contiguous()
    o, state = linear_attention_with_state(heads(r), heads(k), heads(v), heads(w.to(x.dtype)),
                                           u_b, shift=1)
    o, state = splittable(o, 0, b), splittable(state, 0, b)
    return S._group_norm_out(p, o.reshape(b, h, t, hd), g), state.reshape(b, h, hd, hd)


def _kv(p: Params, xn: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor | None = None):
    """K (after RoPE where ``positions`` are given) and V, ``(B, Hkv, S, hd)``."""
    dtype = xn.dtype
    k = L._split_heads(L.linear(p["wk"], xn, dtype), cfg.n_kv_heads)
    v = L._split_heads(L.linear(p["wv"], xn, dtype), cfg.n_kv_heads)
    k = constrain(k, "batch", ("kv_heads",), None, None)  # as attn_forward's
    v = constrain(v, "batch", ("kv_heads",), None, None)
    if cfg.use_rope and positions is not None:
        k = L.rope(k, positions, cfg.rope_theta)
    return k, v


def _self_attn_with_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, window: int | None):
    """Self-attention that also returns ``(k, v)`` for the cache."""
    dtype = x.dtype
    b, s, _ = x.shape
    q = constrain(L._split_heads(L.linear(p["wq"], x, dtype), cfg.n_heads),
                  "batch", ("heads", "qseq"), ("qseq",), None)
    pos = torch.arange(s, device=x.device)
    k, v = _kv(p, x, cfg, positions=pos)
    if cfg.use_rope:
        q = L.rope(q, pos, cfg.rope_theta)
    o = L.flash_attention(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap)
    o = constrain(o, "batch", ("heads", "qseq"), ("qseq",), None)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return L.linear(p["wo"], o, dtype), k, v


def _cross_attn_with_kv(p: Params, xn: torch.Tensor, mem: torch.Tensor, cfg: ModelConfig):
    """Cross-attention of ``xn`` over ``mem`` (``attn_forward`` with
    ``kv_override``: no mask, no RoPE) that also returns the memory's ``(k,
    v)`` for the cache."""
    b, s, _ = xn.shape
    k, v = _kv(p, mem, cfg)
    q = constrain(L._split_heads(L.linear(p["wq"], xn, xn.dtype), cfg.n_heads),
                  "batch", ("heads", "qseq"), ("qseq",), None)
    o = constrain(L.flash_attention(q, k, v, causal=False, softcap=cfg.attn_softcap),
                  "batch", ("heads", "qseq"), ("qseq",), None)
    return L.linear(p["wo"], o.transpose(1, 2).reshape(b, s, cfg.q_dim), xn.dtype), k, v


def _dense_block_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, window: int | None):
    xn = L.apply_norm(p["ln1"], x, cfg)
    h, k, v = _self_attn_with_kv(p["attn"], xn, cfg, window)
    if cfg.sandwich_norm:
        h = L.apply_norm(p["ln1_post"], h, cfg)
    x = x + h
    y = ffn_forward(p, L.apply_norm(p["ln2"], x, cfg), cfg)
    if cfg.sandwich_norm:
        y = L.apply_norm(p["ln2_post"], y, cfg)
    return x + y, k, v


def _dense_prefill(cfg: ModelConfig, params: Params, x: torch.Tensor, max_seq: int,
                   cache_dtype: torch.dtype) -> tuple[torch.Tensor, Params]:
    """The dense layers over ``x: (B, S, D)``; the cache is allocated once,
    zero, and each layer's K / V is written into its first ``S`` positions
    (stacking the layers and then padding would hold a second cache)."""
    b, s, _ = x.shape
    cache = new_cache(cfg, b, max_seq, cache_dtype, x)
    for i, window in enumerate(_layer_windows(cfg)):
        x, k, v = _dense_block_prefill(layer_params(params["blocks"], i), x, cfg, window)
        L.write_seq(cache["k"][i], 0, k)
        L.write_seq(cache["v"][i], 0, v)
    return x, cache


def _mamba2_with_state(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """:func:`repro_torch.models.ssm.mamba2_forward` that also returns the
    conv state ``(B, K-1, inner)`` in ``x``'s dtype (zeros before the first
    token where the prompt is shorter than ``K - 1``) and the final SSD
    state ``(B, H, N, P)`` f32, through the ``(BH, T, D)`` entry of the
    linear-attention kernel (``u = 0``, shift 0)."""
    b, t, _ = x.shape
    xin, z, bmat, cmat, dt = S._in_proj(p, x, cfg)
    xconv, xpad = S._causal_conv(p, xin, cfg)
    conv_state = xpad[:, t:]  # the last K-1 raw (pre-activation) inputs
    q, k, v, w = S._ssd_inputs(p, xconv, bmat, cmat, dt, cfg)
    h, n, ph = q.shape[1], q.shape[3], v.shape[3]

    def flat(a):
        return mergeable(a, 1).reshape(b * h, t, a.shape[-1]).contiguous()

    u0 = torch.zeros((b * h, 1, n), dtype=x.dtype, device=x.device)
    o, state = linear_attention_with_state(flat(q), flat(k), flat(v), flat(w), u0, shift=0)
    o, state = splittable(o, 0, b), splittable(state, 0, b)
    return (S._ssd_out(p, o.reshape(b, h, t, ph), v, z, cfg), conv_state,
            state.reshape(b, h, n, ph))


def _hybrid_prefill(cfg: ModelConfig, params: Params, x: torch.Tensor, max_seq: int,
                    cache_dtype: torch.dtype) -> tuple[torch.Tensor, Params]:
    """The Mamba2 layers over ``x: (B, S, D)``, the shared block after every
    ``hybrid_period`` of them; the cache is allocated once and each layer's
    states and each application's K / V are written into it."""
    b, s, _ = x.shape
    cache = new_cache(cfg, b, max_seq, cache_dtype, x)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        y, conv, state = _mamba2_with_state(p["mamba"], L.apply_norm(p["ln1"], x, cfg), cfg)
        L.put(cache["conv"][i], conv)
        L.put(cache["ssm"][i], state)
        x = x + y
        j = shared_application(cfg, i)
        if j is not None:
            x, k, v = _dense_block_prefill(params["shared"], x, cfg, None)
            L.write_seq(cache["sk"][j], 0, k)
            L.write_seq(cache["sv"][j], 0, v)
    return x, cache


def _audio_prefill(cfg: ModelConfig, params: Params, x: torch.Tensor, extras: torch.Tensor,
                   max_seq: int, cache_dtype: torch.dtype) -> tuple[torch.Tensor, Params]:
    """The encoder over ``extras``, then the decoder layers over ``x: (B, S,
    D)``; each layer's self K / V go into ``k`` / ``v`` and its
    cross-attention's K / V of the encoder's output into ``xk`` / ``xv``."""
    b, s, _ = x.shape
    enc = encode(cfg, params, extras)
    cache = new_cache(cfg, b, max_seq, cache_dtype, x)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h, k, v = _self_attn_with_kv(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, None)
        L.write_seq(cache["k"][i], 0, k)
        L.write_seq(cache["v"][i], 0, v)
        x = x + h
        h, xk, xv = _cross_attn_with_kv(p["cross"], L.apply_norm(p["ln_x"], x, cfg), enc, cfg)
        L.put(cache["xk"][i], xk)
        L.put(cache["xv"][i], xv)
        x = x + h
        x = x + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)
    return x, cache


def _vlm_prefill(cfg: ModelConfig, params: Params, x: torch.Tensor, extras: torch.Tensor,
                 max_seq: int, cache_dtype: torch.dtype) -> tuple[torch.Tensor, Params]:
    """The units over ``x: (B, S, D)``: each dense layer's K / V into its
    row of ``k`` / ``v``, then the cross block, its K / V of the patch
    embeddings into ``xk`` / ``xv``."""
    b, s, _ = x.shape
    vision = extras.to(_dtype(cfg))
    cache = new_cache(cfg, b, max_seq, cache_dtype, x)
    for u in range(cfg.n_layers // cfg.cross_attn_period):
        for j in range(cfg.cross_attn_period - 1):
            i = vlm_self_layer(cfg, u, j)
            x, k, v = _dense_block_prefill(layer_params(params["blocks"], i), x, cfg, None)
            L.write_seq(cache["k"][i], 0, k)
            L.write_seq(cache["v"][i], 0, v)
        c = layer_params(params["cross_blocks"], u)
        h, xk, xv = _cross_attn_with_kv(c["cross"], L.apply_norm(c["ln1"], x, cfg), vision, cfg)
        L.put(cache["xk"][u], xk)
        L.put(cache["xv"][u], xv)
        x = gated(c, x, h, cfg)
    return x, cache
