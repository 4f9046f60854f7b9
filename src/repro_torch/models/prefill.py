"""Prefill: the full-sequence forward pass that also builds the decode
cache, for the ``ssm`` family (the counterpart of ``repro.models.prefill``).

Returns ``(last-token logits, cache)`` with the cache laid out as
:func:`repro_torch.models.decode.init_cache`: ``prev1`` / ``prev2`` (the
last normalised input of each layer's two mixes) in the cache dtype and
``wkv`` (the linear-attention state) in fp32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.linear_attn.ops import linear_attention_with_state
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.backbone import check_family, embed, layer_params, logits_for_position
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

__all__ = ["prefill"]


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S)
    *,
    extras: torch.Tensor | None = None,
    max_seq: int | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, Params]:
    """``extras`` and ``max_seq`` are the reference's arguments for the
    families with an encoder or a KV cache; the ``ssm`` state does not grow
    with the sequence, so both go unused."""
    check_family(cfg)
    x = embed(cfg, params, tokens)
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
    cache = {"prev1": torch.stack(prev1), "prev2": torch.stack(prev2), "wkv": torch.stack(wkv)}
    x_last = L.apply_norm(params["final_norm"], x[:, -1:], cfg)[:, 0]
    return logits_for_position(cfg, params, x_last), cache


def _rwkv_time_mix_with_state(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """:func:`repro_torch.models.ssm.rwkv_time_mix` that also returns the
    final state ``(B, H, hd, hd)`` f32, through the ``(BH, T, hd)`` entry of
    the linear-attention kernel."""
    b, t, d = x.shape
    h = cfg.n_heads
    hd = d // h
    r, k, v, g, w = S._projections(p, x, S._token_shift(x))

    def heads(a):
        return a.reshape(b, t, h, hd).transpose(1, 2).reshape(b * h, t, hd).contiguous()

    u_b = p["u"].reshape(1, h, hd).to(x.dtype).expand(b, h, hd).reshape(b * h, 1, hd)
    u_b = u_b.contiguous()
    o, state = linear_attention_with_state(heads(r), heads(k), heads(v), heads(w.to(x.dtype)),
                                           u_b, shift=1)
    return S._group_norm_out(p, o.reshape(b, h, t, hd), g), state.reshape(b, h, hd, hd)
