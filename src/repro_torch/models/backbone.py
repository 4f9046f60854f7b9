"""Backbone assembly for the ``ssm`` family (RWKV6): parameters stacked on
a leading layer axis, the full-sequence forward pass and the logits of one
position.  The counterpart of ``repro.models.backbone``; where the reference
scans over the stacked layer axis, the port loops over layers in Python.
The other families, ``chunked_ce_loss`` and training are not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

__all__ = ["init_params", "init_rwkv_block", "forward_hidden", "logits_for_position",
           "layer_params", "check_family"]


def check_family(cfg: ModelConfig) -> None:
    """Raise unless the port serves ``cfg``'s family (only ``ssm`` so far)."""
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the port serves the "
            "'ssm' family (RWKV6) only (see ROADMAP.md, queue 1)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack_init(generator: torch.Generator, n: int, init_fn) -> Params:
    """``n`` blocks' parameters stacked on a leading axis: ``init_fn(generator,
    lead=(n,))`` draws every leaf for all ``n`` layers at once (the
    reference vmaps one init over ``n`` keys; the distributions are the
    same)."""
    return init_fn(generator, (n,))


def init_rwkv_block(generator: torch.Generator, cfg: ModelConfig,
                    lead: tuple[int, ...] = ()) -> Params:
    dev = generator.device
    return {
        "ln1": L.init_norm(cfg, lead=lead, device=dev),
        "time_mix": S.init_rwkv_time_mix(generator, cfg, lead),
        "ln2": L.init_norm(cfg, lead=lead, device=dev),
        "channel_mix": S.init_rwkv_channel_mix(generator, cfg, lead),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """fp32 master parameters on ``generator``'s device, with the
    reference's distributions and scales (not its bits: ``jax.random`` and
    ``torch`` differ)."""
    check_family(cfg)
    d = cfg.d_model
    dev = generator.device
    p: Params = {
        # padded vocab (multiple of 256); padded logits are masked
        "embed": torch.randn((cfg.padded_vocab, d), generator=generator, device=dev) * 0.02,
        "final_norm": L.init_norm(cfg, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_linear(generator, d, cfg.padded_vocab)
    p["blocks"] = _stack_init(generator, cfg.n_layers,
                              lambda g, lead: init_rwkv_block(g, cfg, lead))
    return p


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """``tokens: (B, S)`` -> final hidden states ``(B, S, D)``, through the
    ``(B, H, T, D)`` entry of the linear-attention kernel."""
    check_family(cfg)
    x = embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        x = x + S.rwkv_time_mix(p["time_mix"], L.apply_norm(p["ln1"], x, cfg), cfg)
        x = x + S.rwkv_channel_mix(p["channel_mix"], L.apply_norm(p["ln2"], x, cfg), cfg)
    return L.apply_norm(params["final_norm"], x, cfg)


def logits_for_position(cfg: ModelConfig, params: Params,
                        hidden_last: torch.Tensor) -> torch.Tensor:
    """``(B, D) -> (B, V)`` fp32 logits; the padded vocabulary is -1e30.

    The reference multiplies in the compute dtype with fp32 results
    (``preferred_element_type``); here the bf16 operands are widened to fp32
    first, which gives the same exact products, summed in fp32."""
    dtype = _dtype(cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    logits = hidden_last.to(dtype).float() @ w.to(dtype).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(mask[None, :], logits, -1e30)
