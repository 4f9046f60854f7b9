"""Architecture registry: --arch <id> resolution + reduced smoke configs.

The port's copy of ``repro.configs.registry`` and its ten config modules
(data only), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "rwkv6-1.6b": "rwkv6_1p6b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen1.5-4b": "qwen15_4b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "granite-3-2b": "granite3_2b",
    "gemma2-9b": "gemma2_9b",
    "zamba2-1.2b": "zamba2_1p2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (shapes shrink, structure
    — GQA ratios, expert counts, patterns — is preserved)."""
    cfg = get_config(name)
    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    upd: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        vocab_chunk=64,
        max_learned_pos=4096,
    )
    if cfg.family == "moe":
        upd.update(n_experts=8 if cfg.n_experts >= 64 else 4,
                   top_k_experts=min(cfg.top_k_experts, 2))
    if cfg.family == "hybrid":
        upd.update(n_layers=8, hybrid_period=3, ssm_state=16)
    if cfg.family == "ssm":
        upd.update(n_layers=4)
    if cfg.family == "audio":
        upd.update(encoder_layers=2, encoder_seq=64)
    if cfg.family == "vlm":
        upd.update(n_layers=5, cross_attn_period=5, vision_tokens=48)
    if cfg.local_global:
        upd.update(local_window=32)
    if cfg.sliding_window is not None:
        upd.update(sliding_window=32)
    return dataclasses.replace(cfg, **upd)
