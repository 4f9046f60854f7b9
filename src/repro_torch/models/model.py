"""Public model API: one object per architecture config (the counterpart of
``repro.models.model``; the port serves the ``dense`` family (qwen1.5-4b,
phi4-mini-3.8b, granite-3-2b, gemma2-9b), the ``ssm`` family (RWKV6) and
the ``hybrid`` family (Zamba2)).

    model = Model(get_config("gemma2-9b"))
    params = model.init(torch.Generator("cuda").manual_seed(0))   # fp32 master
    params = model.compute_params(params)     # linear weights cast once
    logits, cache = model.prefill(params, tokens)
    logits, cache = model.decode_step(params, cache, token, pos)

A dense model's ``decode_step`` writes the new token's K / V into ``cache``
in place and returns it; an ``ssm`` model's returns a new state; a
``hybrid`` model's writes its shared block's K / V in place and returns new
Mamba2 states.

``input_specs`` (a JAX dry-run helper) and ``loss`` (training) are not
ported.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import backbone, decode as D, prefill as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, cast_linears

__all__ = ["Model", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


class Model:
    """Raises ``NotImplementedError`` for a family the port does not serve
    yet (``moe``, ``audio`` and ``vlm``; see ROADMAP.md, queue 1)."""

    def __init__(self, cfg: ModelConfig):
        backbone.check_family(cfg)
        self.cfg = cfg

    # -- parameters --------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """fp32 master parameters, drawn on ``generator``'s device."""
        return backbone.init_params(self.cfg, generator)

    def compute_params(self, params: Params) -> Params:
        """``params`` with each linear weight cast once to the config dtype
        (what the reference casts on every call); the other leaves shared."""
        return cast_linears(params, getattr(torch, self.cfg.dtype))

    # -- serving -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cuda") -> Params:
        return D.init_cache(self.cfg, batch, max_seq, dtype, device)

    def prefill(self, params, tokens, *, extras=None, max_seq=None):
        return P.prefill(self.cfg, params, tokens, extras=extras, max_seq=max_seq)

    def decode_step(self, params, cache, token, pos):
        return D.decode_step(self.cfg, params, cache, token, pos)
