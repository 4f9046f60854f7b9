"""Single-token decode with every family's cache (the counterpart of
``repro.models.decode``):

  dense, moe    {"k", "v": (L, B, Hkv, Smax, hd)}  in the cache dtype
  vlm           {"k", "v": (Ls, B, Hkv, Smax, hd)}  (the Ls = L - L // period
  (llama-vision) dense layers) + read-only {"xk", "xv": (Lc, B, Hkv, Tv, hd)}
                (the Lc = L // period cross blocks' K / V of the Tv patches)
  audio         {"k", "v": (L, B, Hkv, Smax, hd)} + read-only
  (whisper)     {"xk", "xv": (L, B, Hkv, Te, hd)}  (each layer's K / V of the
                Te encoder frames)
  ssm (rwkv6)   {"prev1", "prev2": (L, B, D), "wkv": (L, B, H, hd, hd) f32}
  hybrid        {"conv": (L, B, K-1, inner), "ssm": (L, B, H, N, P) f32,
  (zamba2)       "sk", "sv": (n_apps, B, Hkv, Smax, hd)}  (the shared block's KV)

A KV cache (dense, moe, vlm and audio ``k`` / ``v``, hybrid ``sk`` / ``sv``)
is updated **in place**: each step writes the new token's K / V at ``pos``
into the tensors it was given (the reference's ``dynamic_update_slice``
under its server's buffer donation), so a step moves no copy of it.  The
cross-attention's ``xk`` / ``xv``, filled once by prefill, are only read
(upcast to fp32 a layer at a time, as the reference reads them).  The
recurrent states (``ssm``'s, and ``hybrid``'s ``conv`` / ``ssm``) are O(1)
in context length and are left as they were: the step returns new ones.  The reference scans
over the stacked layer axis; the port loops over layers.  The reference's
``hybrid`` scan computes the shared block after every layer and keeps it
(``jnp.where``) only after every ``hybrid_period``-th; the port runs it only
there (6 of Zamba2-1.2B's 38 layers): the same answers with less work.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.backbone import (
    _layer_windows,
    check_family,
    embed,
    ffn_forward,
    gated,
    layer_params,
    logits_for_position,
    memory_tokens,
    shared_application,
    vlm_self_layer,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

__all__ = ["init_cache", "decode_step"]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> Params:
    """An all-zero cache (the ``ssm`` state does not grow, so it ignores
    ``max_seq``)."""
    check_family(cfg)
    if cfg.family in ("dense", "moe"):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family in ("vlm", "audio"):
        n_self = n_cross = cfg.n_layers
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_period
            n_self -= n_cross
        kv = (n_self, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        mem = (n_cross, batch, cfg.n_kv_heads, memory_tokens(cfg), cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                "xk": torch.zeros(mem, dtype=dtype, device=device),
                "xv": torch.zeros(mem, dtype=dtype, device=device)}
    if cfg.family == "hybrid":
        inner, h = cfg.ssm_expand * cfg.d_model, cfg.n_heads
        kv = (cfg.n_layers // cfg.hybrid_period, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, inner), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_state, inner // h),
                               dtype=torch.float32, device=device),
            "sk": torch.zeros(kv, dtype=dtype, device=device),
            "sv": torch.zeros(kv, dtype=dtype, device=device),
        }
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {
        "prev1": torch.zeros((cfg.n_layers, batch, d), dtype=dtype, device=device),
        "prev2": torch.zeros((cfg.n_layers, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((cfg.n_layers, batch, h, hd, hd), dtype=torch.float32,
                           device=device),
    }


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    token: torch.Tensor,  # (B,)
    pos: int,  # current write position
) -> tuple[torch.Tensor, Params]:
    """-> ``(logits (B, V) f32, cache)``.  A dense, ``moe``, ``vlm`` or
    ``audio`` ``cache`` is written in place at ``pos`` and returned (its
    ``xk`` / ``xv`` only read); an ``ssm`` ``cache`` is left as it was and a
    new one returned; a ``hybrid`` one has its ``sk`` / ``sv`` written in
    place at ``pos`` and comes back in a new dict with new ``conv`` /
    ``ssm`` states.  Whisper raises ``IndexError`` at ``pos`` past its
    learned positions."""
    check_family(cfg)
    x = embed(cfg, params, token, pos)  # (B, D)
    if cfg.family in ("dense", "moe"):
        for i, window in enumerate(_layer_windows(cfg)):
            x = _dense_block_decode(layer_params(params["blocks"], i), x, cache["k"][i],
                                    cache["v"][i], pos, cfg, window)
    elif cfg.family == "ssm":
        x, cache = _rwkv_decode(cfg, params, cache, x)
    elif cfg.family == "hybrid":
        x, cache = _hybrid_decode(cfg, params, cache, x, pos)
    elif cfg.family == "vlm":
        x = _vlm_decode(cfg, params, cache, x, pos)
    else:
        x = _audio_decode(cfg, params, cache, x, pos)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return logits_for_position(cfg, params, x), cache


def _rwkv_decode(cfg: ModelConfig, params: Params, cache: Params,
                 x: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """The RWKV6 layers for ``x: (B, D)``; ``cache`` is left as it was and a
    new one returned."""
    prev1, prev2, wkv = [], [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        p1, p2 = cache["prev1"][i], cache["prev2"][i]
        xn = L.apply_norm(p["ln1"], x, cfg)
        h, np1, state = S.rwkv_time_mix_decode(p["time_mix"], xn, p1, cache["wkv"][i], cfg)
        x = x + h
        xn2 = L.apply_norm(p["ln2"], x, cfg)
        h2, np2 = S.rwkv_channel_mix_decode(p["channel_mix"], xn2, p2, cfg)
        x = x + h2
        prev1.append(L.placed_as(np1.to(p1.dtype), p1))
        prev2.append(L.placed_as(np2.to(p2.dtype), p2))
        wkv.append(L.placed_as(state, cache["wkv"][i]))
    return x, dict(cache, prev1=torch.stack(prev1), prev2=torch.stack(prev2),
                   wkv=torch.stack(wkv))


def _hybrid_decode(cfg: ModelConfig, params: Params, cache: Params, x: torch.Tensor,
                   pos: int) -> tuple[torch.Tensor, Params]:
    """The Mamba2 layers for ``x: (B, D)``, the shared block's decode after
    every ``hybrid_period`` of them against its application's views of
    ``sk`` / ``sv`` (written in place at ``pos``)."""
    conv, ssm = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h, nconv, state = S.mamba2_decode(p["mamba"], L.apply_norm(p["ln1"], x, cfg),
                                          cache["conv"][i], cache["ssm"][i], cfg)
        x = x + h
        conv.append(L.placed_as(nconv, cache["conv"][i]))
        ssm.append(L.placed_as(state, cache["ssm"][i]))
        j = shared_application(cfg, i)
        if j is not None:
            x = _dense_block_decode(params["shared"], x, cache["sk"][j], cache["sv"][j], pos,
                                    cfg, None)
    return x, dict(cache, conv=torch.stack(conv), ssm=torch.stack(ssm))


def _dense_block_decode(p: Params, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                        pos: int, cfg: ModelConfig, window: int | None) -> torch.Tensor:
    """One dense layer for ``x: (B, D)``; ``ck`` / ``cv`` (the layer's views
    of the cache) are written in place at ``pos``."""
    h = L.attn_decode(p["attn"], L.apply_norm(p["ln1"], x[:, None], cfg), ck, cv, pos, cfg,
                      window=window)[0][:, 0]
    if cfg.sandwich_norm:
        h = L.apply_norm(p["ln1_post"], h, cfg)
    x = x + h
    y = ffn_forward(p, L.apply_norm(p["ln2"], x[:, None], cfg), cfg)[:, 0]
    if cfg.sandwich_norm:
        y = L.apply_norm(p["ln2_post"], y, cfg)
    return x + y


def _cross_decode(p: Params, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One token's cross-attention, ``x: (B, D)``, over a layer's memory K /
    V ``(B, Hkv, T, hd)``: q in the compute dtype, cast to fp32 and scaled;
    ``xk`` / ``xv`` read as fp32; a plain softmax, no mask; ``wo`` on the
    result cast back, as the reference's ``_cross_decode``."""
    b = x.shape[0]
    q = L._split_heads(L.linear(p["wq"], x[:, None], x.dtype), cfg.n_heads)  # (B, Hq, 1, h)
    s = L._grouped(q, cfg.n_kv_heads) @ xk.float().transpose(-1, -2)  # (B, Hkv, G, T)
    o = (torch.softmax(s, dim=-1) @ xv.float()).reshape(b, cfg.q_dim)
    return L.linear(p["wo"], o.to(x.dtype), x.dtype)


def _vlm_decode(cfg: ModelConfig, params: Params, cache: Params, x: torch.Tensor,
                pos: int) -> torch.Tensor:
    """The units for ``x: (B, D)``: each dense layer against its row of
    ``k`` / ``v`` (written in place at ``pos``), then the cross block
    against its row of ``xk`` / ``xv``."""
    for u in range(cfg.n_layers // cfg.cross_attn_period):
        for j in range(cfg.cross_attn_period - 1):
            i = vlm_self_layer(cfg, u, j)
            x = _dense_block_decode(layer_params(params["blocks"], i), x, cache["k"][i],
                                    cache["v"][i], pos, cfg, None)
        c = layer_params(params["cross_blocks"], u)
        h = _cross_decode(c["cross"], L.apply_norm(c["ln1"], x, cfg), cache["xk"][u],
                          cache["xv"][u], cfg)
        x = gated(c, x, h, cfg)
    return x


def _audio_decode(cfg: ModelConfig, params: Params, cache: Params, x: torch.Tensor,
                  pos: int) -> torch.Tensor:
    """The decoder layers for ``x: (B, D)``: self-attention against ``k`` /
    ``v`` (written in place at ``pos``), cross-attention against ``xk`` /
    ``xv``, the MLP."""
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        x = x + L.attn_decode(p["attn"], L.apply_norm(p["ln1"], x[:, None], cfg),
                              cache["k"][i], cache["v"][i], pos, cfg)[0][:, 0]
        x = x + _cross_decode(p["cross"], L.apply_norm(p["ln_x"], x, cfg), cache["xk"][i],
                              cache["xv"][i], cfg)
        x = x + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)
    return x
