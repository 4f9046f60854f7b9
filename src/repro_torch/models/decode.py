"""Single-token decode with the ``ssm`` family's cache (the counterpart of
``repro.models.decode``):

  ssm (rwkv6) {"prev1", "prev2": (L, B, D), "wkv": (L, B, H, hd, hd) f32}

The state is O(1) in context length.  The reference scans over the stacked
layer axis; the port loops over layers and stacks the new cache.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.backbone import check_family, embed, layer_params, logits_for_position
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

__all__ = ["init_cache", "decode_step"]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> Params:
    """An all-zero cache (``max_seq`` goes unused: the state does not grow)."""
    check_family(cfg)
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
    pos: int,  # current write position (unused by the ssm state)
) -> tuple[torch.Tensor, Params]:
    """-> ``(logits (B, V) f32, new cache)``; ``cache`` is left as it was."""
    check_family(cfg)
    x = embed(cfg, params, token)  # (B, D)
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
        prev1.append(np1.to(p1.dtype))
        prev2.append(np2.to(p2.dtype))
        wkv.append(state)
    new_cache = dict(cache, prev1=torch.stack(prev1), prev2=torch.stack(prev2),
                     wkv=torch.stack(wkv))
    x = L.apply_norm(params["final_norm"], x, cfg)
    return logits_for_position(cfg, params, x), new_cache
