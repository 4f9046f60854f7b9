"""Public model API: one object per architecture config (the counterpart of
``repro.models.model``; the port serves every family of the JAX package:
``dense`` (qwen1.5-4b, phi4-mini-3.8b, granite-3-2b, gemma2-9b), ``moe``
(olmoe-1b-7b, mixtral-8x7b), ``ssm`` (RWKV6), ``hybrid`` (Zamba2),
``audio`` (whisper-large-v3) and ``vlm`` (llama-3.2-vision-11b)).

    model = Model(get_config("gemma2-9b"))
    params = model.init(torch.Generator("cuda").manual_seed(0))   # fp32 master
    params = model.compute_params(params)     # linear and expert weights cast once
    logits, cache = model.prefill(params, tokens)
    logits, cache = model.decode_step(params, cache, token, pos)

``audio`` and ``vlm`` models take ``extras`` at prefill: Whisper's frame
embeddings ``(B, 1500, 1280)``, Llama-3.2-Vision's patch embeddings ``(B,
1601, 4096)`` (the audio front end and the vision encoder are stubs, as in
the reference); prefill stores their K / V in the cache (``xk`` / ``xv``),
which decode only reads.

A dense, MoE, ``audio`` or ``vlm`` model's ``decode_step`` writes the new
token's K / V into ``cache`` in place and returns it; an ``ssm`` model's
returns a new state; a ``hybrid`` model's writes its shared block's K / V
in place and returns new Mamba2 states.

Training (``repro_torch.train``) takes the fp32 master as it is:

    loss = model.loss(params, {"tokens": ..., "labels": ...})   # remat on
    shapes = model.param_shapes()          # meta tensors, for a restore

``input_specs(cfg, shape)`` gives ``meta`` tensors for every input of a
dry-run cell (:data:`SHAPES`), the decode cache included: shapes and dtypes,
no storage (the counterpart of the reference's ``ShapeDtypeStruct``s).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import backbone, decode as D, prefill as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, cast_linears

__all__ = ["Model", "ShapeSpec", "SHAPES", "input_specs"]


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
    """Raises ``NotImplementedError`` for a family the JAX package does not
    have."""

    def __init__(self, cfg: ModelConfig):
        backbone.check_family(cfg)
        self.cfg = cfg

    # -- parameters --------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """fp32 master parameters, drawn on ``generator``'s device."""
        return backbone.init_params(self.cfg, generator)

    def param_shapes(self) -> Params:
        """The parameter tree as ``meta`` tensors: no allocation."""
        return backbone.param_shapes(self.cfg)

    def compute_params(self, params: Params) -> Params:
        """``params`` with each linear weight and each MoE layer's expert
        tensors cast once to the config dtype (what the reference casts on
        every call); the other leaves shared (the norms, the embedding, a
        cross block's ``gate`` and Whisper's ``enc_pos`` / ``dec_pos`` stay
        fp32: the reference casts them at use)."""
        return cast_linears(params, getattr(torch, self.cfg.dtype))

    # -- training ----------------------------------------------------------
    def loss(self, params: Params, batch: dict, *, remat: bool = True) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels`` ``(B, S)``, and ``extras`` for the ``audio`` and ``vlm``
        families) as an fp32 0-dim tensor; ``params`` is the fp32 master,
        each weight cast to the compute dtype at its use, so autograd carries
        the gradients to it."""
        hidden = backbone.forward_hidden(self.cfg, params, batch["tokens"],
                                         extras=batch.get("extras"), remat=remat)
        return backbone.chunked_ce_loss(self.cfg, params, hidden, batch["labels"])

    # -- serving -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cuda") -> Params:
        return D.init_cache(self.cfg, batch, max_seq, dtype, device)

    def prefill(self, params, tokens, *, extras=None, max_seq=None):
        return P.prefill(self.cfg, params, tokens, extras=extras, max_seq=max_seq)

    def decode_step(self, params, cache, token, pos):
        return D.decode_step(self.cfg, params, cache, token, pos)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_spec(cfg: ModelConfig, batch: int, dtype: torch.dtype) -> torch.Tensor | None:
    if cfg.family == "audio":
        return _meta((batch, cfg.encoder_seq, cfg.d_model), dtype)
    if cfg.family == "vlm":
        return _meta((batch, cfg.vision_tokens, cfg.d_model), dtype)
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for every model input of the given cell: int32
    ``tokens`` / ``labels`` ``(B, S)`` (``train``), ``tokens`` (``prefill``),
    each with the ``audio`` / ``vlm`` family's ``extras`` in the config
    dtype; ``token (B,)``, ``pos ()`` and the bf16 ``cache`` of ``S``
    positions (``decode``)."""
    dtype = getattr(torch, cfg.dtype)
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((b, s), tok)}
        if shape.kind == "train":
            out["labels"] = _meta((b, s), tok)
        ex = _extras_spec(cfg, b, dtype)
        if ex is not None:
            out["extras"] = ex
        return out
    if shape.kind == "decode":
        return {"token": _meta((b,), tok), "pos": _meta((), tok),
                "cache": D.init_cache(cfg, b, s, torch.bfloat16, "meta")}
    raise ValueError(shape.kind)
