"""Backbone assembly for the ``dense`` family (qwen1.5, phi4-mini, granite,
Gemma2), the ``moe`` family (OLMoE, Mixtral: the dense block with its MLP
swapped for the top-k MoE layer), the ``ssm`` family (RWKV6) and the
``hybrid`` family (Zamba2: Mamba2 layers with one *shared* dense block
applied after every ``hybrid_period`` of them, the same parameters each
time): parameters
stacked on a leading layer axis (the shared block unstacked), the
full-sequence forward pass and the logits of one position.  The counterpart
of ``repro.models.backbone``; where the reference scans over the stacked
layer axis, the port loops over layers in Python, so a layer's attention
window is a Python ``int`` or ``None`` (global) and one ``flash_attention``
serves every layer (the reference's traced-window twin, ``_flash_dynwin``,
has no counterpart).  The ``audio`` and ``vlm`` families,
``chunked_ce_loss`` and training are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

__all__ = ["init_params", "init_dense_block", "init_rwkv_block", "init_mamba_block",
           "forward_hidden", "logits_for_position", "layer_params", "check_family",
           "shared_application", "ffn_forward"]


def check_family(cfg: ModelConfig) -> None:
    """Raise unless the port serves ``cfg``'s family (``dense``, ``moe``,
    ``ssm`` or ``hybrid``)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the port serves the "
            "'dense' family, the 'moe' family (OLMoE, Mixtral), the 'ssm' family (RWKV6) and "
            "the 'hybrid' family (Zamba2) only (see ROADMAP.md, queue 1)")


def shared_application(cfg: ModelConfig, i: int) -> int | None:
    """``hybrid``: which application of the shared block follows Mamba2
    layer ``i`` (one after every ``hybrid_period`` layers; the layers past
    the last whole period are a tail with none), else ``None``."""
    if (i + 1) % cfg.hybrid_period:
        return None
    return (i + 1) // cfg.hybrid_period - 1


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack_init(generator: torch.Generator, n: int, init_fn) -> Params:
    """``n`` blocks' parameters stacked on a leading axis: ``init_fn(generator,
    lead=(n,))`` draws every leaf for all ``n`` layers at once (the
    reference vmaps one init over ``n`` keys; the distributions are the
    same)."""
    return init_fn(generator, (n,))


def init_dense_block(generator: torch.Generator, cfg: ModelConfig,
                     lead: tuple[int, ...] = ()) -> Params:
    """Attention and MLP with their pre-norms, and Gemma2's post-norms
    (``sandwich_norm``); a ``moe`` config draws the MoE layer (``"moe"``)
    in place of the MLP."""
    dev = generator.device
    p = {
        "ln1": L.init_norm(cfg, lead=lead, device=dev),
        "attn": L.init_attention(generator, cfg, lead=lead),
        "ln2": L.init_norm(cfg, lead=lead, device=dev),
    }
    if cfg.family == "moe":
        p["moe"] = L.init_moe(generator, cfg, lead)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, lead)
    if cfg.sandwich_norm:
        p["ln1_post"] = L.init_norm(cfg, lead=lead, device=dev)
        p["ln2_post"] = L.init_norm(cfg, lead=lead, device=dev)
    return p


def init_rwkv_block(generator: torch.Generator, cfg: ModelConfig,
                    lead: tuple[int, ...] = ()) -> Params:
    dev = generator.device
    return {
        "ln1": L.init_norm(cfg, lead=lead, device=dev),
        "time_mix": S.init_rwkv_time_mix(generator, cfg, lead),
        "ln2": L.init_norm(cfg, lead=lead, device=dev),
        "channel_mix": S.init_rwkv_channel_mix(generator, cfg, lead),
    }


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig,
                     lead: tuple[int, ...] = ()) -> Params:
    return {"ln1": L.init_norm(cfg, lead=lead, device=generator.device),
            "mamba": S.init_mamba2(generator, cfg, lead)}


_BLOCKS = {"dense": init_dense_block, "moe": init_dense_block, "ssm": init_rwkv_block,
           "hybrid": init_mamba_block}


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
    block = _BLOCKS[cfg.family]
    p["blocks"] = _stack_init(generator, cfg.n_layers, lambda g, lead: block(g, cfg, lead))
    if cfg.family == "hybrid":  # one dense block, applied every hybrid_period layers
        p["shared"] = init_dense_block(generator, dataclasses.replace(cfg, family="dense"))
    return p


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows in the compute dtype; Gemma's ``embed_scale``
    multiplies them by ``sqrt(d_model)`` rounded to that dtype, as the
    reference's weakly typed constant is."""
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    if cfg.embed_scale:
        x = x * L._scalar(math.sqrt(cfg.d_model), x)
    return x


def ffn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A dense block's feed-forward half: the MoE layer where the block has
    one, else the MLP."""
    return L.moe_forward(p["moe"], x, cfg) if "moe" in p else L.mlp_forward(p["mlp"], x, cfg)


def _dense_block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     window: int | None) -> torch.Tensor:
    h = L.attn_forward(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, window=window)
    if cfg.sandwich_norm:
        h = L.apply_norm(p["ln1_post"], h, cfg)
    x = x + h
    y = ffn_forward(p, L.apply_norm(p["ln2"], x, cfg), cfg)
    if cfg.sandwich_norm:
        y = L.apply_norm(p["ln2_post"], y, cfg)
    return x + y


def _layer_windows(cfg: ModelConfig) -> list[int | None]:
    """Each layer's attention window, ``None`` for a global layer: Gemma2's
    even layers are local (``local_global``), a ``sliding_window`` applies
    to every layer."""
    if cfg.local_global:
        return [cfg.local_window if i % 2 == 0 else None for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """``tokens: (B, S)`` -> final hidden states ``(B, S, D)``; the ``ssm``
    and ``hybrid`` families go through the ``(B, H, T, D)`` entry of the
    linear-attention kernel."""
    check_family(cfg)
    x = embed(cfg, params, tokens)
    windows = _layer_windows(cfg)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        if cfg.family in ("dense", "moe"):
            x = _dense_block_fwd(p, x, cfg, windows[i])
        elif cfg.family == "ssm":
            x = x + S.rwkv_time_mix(p["time_mix"], L.apply_norm(p["ln1"], x, cfg), cfg)
            x = x + S.rwkv_channel_mix(p["channel_mix"], L.apply_norm(p["ln2"], x, cfg), cfg)
        else:
            x = x + S.mamba2_forward(p["mamba"], L.apply_norm(p["ln1"], x, cfg), cfg)
            if shared_application(cfg, i) is not None:
                x = _dense_block_fwd(params["shared"], x, cfg, None)
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
