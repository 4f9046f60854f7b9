"""Backbone assembly for every family of the LM stack: ``dense`` (qwen1.5,
phi4-mini, granite, Gemma2), ``moe`` (OLMoE, Mixtral: the dense block with
its MLP swapped for the top-k MoE layer), ``ssm`` (RWKV6), ``hybrid``
(Zamba2: Mamba2 layers with one *shared* dense block applied after every
``hybrid_period`` of them, the same parameters each time), ``audio``
(Whisper: an encoder over precomputed frame embeddings, then decoder
layers of self-attention, cross-attention over the encoder's output and a
GELU MLP, with learned positions) and ``vlm`` (Llama-3.2-Vision: units of
``cross_attn_period - 1`` dense layers then one block of tanh-gated
cross-attention over precomputed patch embeddings and an ungated MLP):
parameters stacked on a leading layer axis (the shared block unstacked),
the full-sequence forward pass and the logits of one position.  The
counterpart of ``repro.models.backbone``; where the reference scans over
the stacked layer axis, the port loops over layers in Python, so a layer's
attention window is a Python ``int`` or ``None`` (global) and one
``flash_attention`` serves every layer (the reference's traced-window twin,
``_flash_dynwin``, has no counterpart).  The frame and patch embeddings
(``extras``) are inputs: the audio front end and the vision encoder are
stubs in the reference too.

Training: :func:`chunked_ce_loss` (the cross-entropy over sequence chunks
of ``vocab_chunk``, each chunk's fp32 logits recomputed in backward rather
than kept), ``forward_hidden(remat=True)`` (activation checkpointing at the
reference's granularity: a block of the dense, MoE, RWKV6 and Whisper
stacks, a Zamba2 unit of ``hybrid_period`` Mamba2 layers and the shared
block, Zamba2's tail layers one by one, a Llama-3.2-Vision unit) and
:func:`param_shapes` (the parameter tree on the ``meta`` device, nothing
allocated).  The forward casts the fp32 master's weights to the compute
dtype at each use, as the reference does on every call, so gradients reach
the master.

Sharded (``DTensor`` params and batch, under
:func:`repro_torch.models.shard_ctx.sharded`): the residual stream is
pinned to ``batch`` at each block's entry and the logits to ``vocab``, as
the reference's ``constrain`` calls; the places where DTensor's own
propagation lacks a rule or would change the layout at a cost take an
explicit step: the embedding lookup (:func:`_sharded_lookup`, a
``local_map`` over the whole table), the loss's rows pinned to ``batch``
before each chunk's product and its logsumexp and gold logit over the
vocab shards (:func:`_lse_gold_sharded`); ``torch.utils.checkpoint``
recomputes DTensor ops as they are (no partial placement crosses a block
boundary).  The optimizer's global norm is a sum of per-leaf partial sums
that DTensor reduces before the ``sqrt``, one all-reduce.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.models.shard_ctx import gather_fsdp
from repro_torch.placements import constrain, dim_sizes, is_dtensor

__all__ = ["init_params", "init_dense_block", "init_rwkv_block", "init_mamba_block",
           "init_encoder_block", "init_encdec_block", "init_cross_block", "forward_hidden",
           "logits_for_position", "layer_params", "check_family", "shared_application",
           "ffn_forward", "vlm_self_layer", "memory_tokens", "encode", "require_extras",
           "gated", "param_shapes", "chunked_ce_loss"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise unless ``cfg``'s family is one of the JAX package's six
    (:data:`FAMILIES`), every one of which the port serves; a ``vlm``
    config must stack whole units (``n_layers`` a multiple of
    ``cross_attn_period``), as the reference's reshape into units needs."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r}; the port "
                                  f"serves {', '.join(FAMILIES)}")
    if cfg.family == "vlm" and (cfg.cross_attn_period < 2
                                or cfg.n_layers % cfg.cross_attn_period):
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a whole number of "
                         f"units of cross_attn_period {cfg.cross_attn_period}")


def vlm_self_layer(cfg: ModelConfig, unit: int, j: int) -> int:
    """``vlm``: the stacked index (and KV cache row) of unit ``unit``'s
    ``j``-th dense layer, ``unit * (period - 1) + j`` (the reference's
    ``reshape(n_units, period - 1, ...)`` of the dense blocks)."""
    return unit * (cfg.cross_attn_period - 1) + j


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


def init_encoder_block(generator: torch.Generator, cfg: ModelConfig,
                       lead: tuple[int, ...] = ()) -> Params:
    """``audio``: an encoder layer, non-causal self-attention and the MLP."""
    dev = generator.device
    return {
        "ln1": L.init_norm(cfg, lead=lead, device=dev),
        "attn": L.init_attention(generator, cfg, lead=lead),
        "ln2": L.init_norm(cfg, lead=lead, device=dev),
        "mlp": L.init_mlp(generator, cfg, lead),
    }


def init_encdec_block(generator: torch.Generator, cfg: ModelConfig,
                      lead: tuple[int, ...] = ()) -> Params:
    """``audio``: a decoder layer, causal self-attention, cross-attention
    over the encoder's output (``cross``, its pre-norm ``ln_x``) and the
    MLP."""
    dev = generator.device
    return {
        "ln1": L.init_norm(cfg, lead=lead, device=dev),
        "attn": L.init_attention(generator, cfg, lead=lead),
        "ln_x": L.init_norm(cfg, lead=lead, device=dev),
        "cross": L.init_attention(generator, cfg, lead=lead),
        "ln2": L.init_norm(cfg, lead=lead, device=dev),
        "mlp": L.init_mlp(generator, cfg, lead),
    }


def init_cross_block(generator: torch.Generator, cfg: ModelConfig,
                     lead: tuple[int, ...] = ()) -> Params:
    """``vlm``: cross-attention over the patch embeddings and the MLP, with
    the residual ``gate`` (fp32 ``(1,)``, zero at init, applied as
    ``tanh(gate)``)."""
    dev = generator.device
    return {
        "ln1": L.init_norm(cfg, lead=lead, device=dev),
        "cross": L.init_attention(generator, cfg, lead=lead),
        "ln2": L.init_norm(cfg, lead=lead, device=dev),
        "mlp": L.init_mlp(generator, cfg, lead),
        "gate": torch.zeros((*lead, 1), device=dev),
    }


_BLOCKS = {"dense": init_dense_block, "moe": init_dense_block, "ssm": init_rwkv_block,
           "hybrid": init_mamba_block, "audio": init_encdec_block, "vlm": init_dense_block}


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
    n_blocks = cfg.n_layers
    if cfg.family == "vlm":  # the dense layers; every period-th layer is a cross block
        n_blocks -= cfg.n_layers // cfg.cross_attn_period
    if cfg.family == "audio":
        p["enc_blocks"] = _stack_init(generator, cfg.encoder_layers,
                                      lambda g, lead: init_encoder_block(g, cfg, lead))
    p["blocks"] = _stack_init(generator, n_blocks, lambda g, lead: block(g, cfg, lead))
    if cfg.family == "hybrid":  # one dense block, applied every hybrid_period layers
        p["shared"] = init_dense_block(generator, dataclasses.replace(cfg, family="dense"))
    if cfg.family == "audio":
        p["enc_pos"] = torch.randn((cfg.encoder_seq, d), generator=generator, device=dev) * 0.02
        p["dec_pos"] = torch.randn((cfg.max_learned_pos, d), generator=generator,
                                   device=dev) * 0.02
        p["enc_final_norm"] = L.init_norm(cfg, device=dev)
    if cfg.family == "vlm":
        p["cross_blocks"] = _stack_init(generator, cfg.n_layers // cfg.cross_attn_period,
                                        lambda g, lead: init_cross_block(g, cfg, lead))
    return p


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree of :func:`init_params` as ``meta`` tensors (the
    shapes and dtypes, no storage): the counterpart of the reference's
    ``jax.eval_shape`` of its init, for a restore to fill."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator())

    def meta(tree):
        return {k: meta(v) if isinstance(v, dict)
                else torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree.items()}

    return meta(fake)


def _remat(fn, remat: bool):
    """``fn`` under activation checkpointing where ``remat`` asks for it and
    autograd records: its activations are dropped after the forward and
    recomputed in the backward."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor, pos: int = 0) -> torch.Tensor:
    """The embedding rows of ``tokens`` (``(B, S)``, or ``(B,)`` for one
    decode step) in the compute dtype, at positions ``pos, pos + 1, ...``;
    Gemma's ``embed_scale`` multiplies them by ``sqrt(d_model)`` rounded to
    that dtype, as the reference's weakly typed constant is.  Whisper's
    learned positions (``learned_pos``) are cast to the compute dtype and
    then added in it, as the reference does; a position past
    ``max_learned_pos`` raises ``IndexError`` (the reference's ``take``
    clamps it, or its slice comes up short)."""
    table = params["embed"]
    if is_dtensor(table):
        x = _sharded_lookup(table, tokens).to(_dtype(cfg))
    else:
        x = table[tokens.long()].to(_dtype(cfg))
    if cfg.embed_scale:
        x = x * L._scalar(math.sqrt(cfg.d_model), x)
    if cfg.learned_pos:
        n = tokens.shape[1] if tokens.dim() == 2 else 1
        if pos < 0 or pos + n > cfg.max_learned_pos:
            raise IndexError(f"positions {pos}..{pos + n - 1} are past the "
                             f"{cfg.max_learned_pos} learned positions")
        rows = params["dec_pos"][pos:pos + n].to(x.dtype)
        x = x + (rows if tokens.dim() == 2 else rows[0])
    return x


def _sharded_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` from a ``DTensor`` table: the table
    whole on every rank (its vocab shards gathered too), each rank looking
    up its own tokens by the unsharded indexing (``local_map``), its rows'
    gradient a partial sum over the batch shards.  DTensor's own
    vocab-sharded lookup gives a masked partial sum, which neither a
    checkpointed block's recompute nor a partial gradient can take, and
    its rule for the indexing's backward is missing in some releases."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    whole = [Replicate()] * mesh.ndim
    rows = [p if p == Shard(0) else Replicate() for p in tokens.placements]
    grad = [Partial() if p == Shard(0) else Replicate() for p in rows]
    look = local_map(lambda t, tok: (t[tok.long()],), out_placements=(rows,),
                     in_placements=(whole, rows), in_grad_placements=(grad, rows),
                     device_mesh=mesh, redistribute_inputs=True)
    return look(table, tokens)[0]


def memory_tokens(cfg: ModelConfig) -> int | None:
    """The rows of ``extras`` a call takes: Whisper's ``encoder_seq`` frames,
    Llama-3.2-Vision's ``vision_tokens`` patches; ``None`` for a family that
    takes none."""
    return {"audio": cfg.encoder_seq, "vlm": cfg.vision_tokens}.get(cfg.family)


def require_extras(cfg: ModelConfig, extras: torch.Tensor | None) -> None:
    """Raise unless an ``audio`` or ``vlm`` call has its ``extras`` (the
    frame or patch embeddings, ``(B, memory_tokens(cfg), D)``)."""
    if memory_tokens(cfg) is not None and extras is None:
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family needs extras, its "
                         f"{'frame' if cfg.family == 'audio' else 'patch'} embeddings")


def encode(cfg: ModelConfig, params: Params, extras: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """``audio``: the encoder over ``extras: (B, encoder_seq, D)``: the
    frames and the learned encoder positions each cast to the compute dtype
    and added in it; each layer's non-causal self-attention and MLP (a
    checkpointed block under ``remat``); the final norm."""
    dtype = _dtype(cfg)
    h = extras.to(dtype) + params["enc_pos"].to(dtype)

    def block(h, p):
        h = constrain(h, "batch", None, None)
        h = h + L.attn_forward(p["attn"], L.apply_norm(p["ln1"], h, cfg), cfg, causal=False)
        return h + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], h, cfg), cfg)

    block = _remat(block, remat)
    for i in range(cfg.encoder_layers):
        h = block(h, layer_params(params["enc_blocks"], i))
    return L.apply_norm(params["enc_final_norm"], h, cfg)


def gated(p: Params, x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``vlm``: the cross block's two residuals given its cross-attention
    output ``h``: ``x + tanh(gate) * h`` (``tanh`` in fp32, cast to ``x``'s
    dtype, as the reference's), then the **ungated** MLP residual (the
    published model gates its MLP too; the reference does not, nor the
    port)."""
    x = x + torch.tanh(p["gate"]).to(x.dtype) * h
    return x + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)


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


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   extras: torch.Tensor | None = None, remat: bool = False) -> torch.Tensor:
    """``tokens: (B, S)`` -> final hidden states ``(B, S, D)``; the ``ssm``
    and ``hybrid`` families go through the ``(B, H, T, D)`` entry of the
    linear-attention kernel; ``audio`` and ``vlm`` attend to ``extras``
    (frames through the encoder, or the patch embeddings as they are).
    ``remat`` checkpoints the reference's blocks (see the module's note) when
    autograd records; it changes no value."""
    check_family(cfg)
    require_extras(cfg, extras)
    x = embed(cfg, params, tokens)
    if cfg.family == "audio":
        enc = encode(cfg, params, extras, remat)

        def dec_block(x, p, enc):
            x = constrain(x, "batch", None, None)
            x = x + L.attn_forward(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg)
            x = x + L.attn_forward(p["cross"], L.apply_norm(p["ln_x"], x, cfg), cfg,
                                   kv_override=enc)
            return x + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)

        dec_block = _remat(dec_block, remat)
        for i in range(cfg.n_layers):
            x = dec_block(x, layer_params(params["blocks"], i), enc)
        return L.apply_norm(params["final_norm"], x, cfg)
    if cfg.family == "vlm":
        vision = extras.to(_dtype(cfg))

        def unit(x, u, vision):
            for j in range(cfg.cross_attn_period - 1):
                p = layer_params(params["blocks"], vlm_self_layer(cfg, u, j))
                x = _dense_block_fwd(p, x, cfg, None)
            c = layer_params(params["cross_blocks"], u)
            h = L.attn_forward(c["cross"], L.apply_norm(c["ln1"], x, cfg), cfg,
                               kv_override=vision)
            return gated(c, x, h, cfg)

        unit = _remat(unit, remat)
        for u in range(cfg.n_layers // cfg.cross_attn_period):
            x = unit(x, u, vision)
        return L.apply_norm(params["final_norm"], x, cfg)
    if cfg.family == "hybrid":
        def mamba(x, i):
            p = layer_params(params["blocks"], i)
            x = constrain(x, "batch", None, None)
            return x + S.mamba2_forward(p["mamba"], L.apply_norm(p["ln1"], x, cfg), cfg)

        def hybrid_unit(x, u):
            for i in range(u * cfg.hybrid_period, (u + 1) * cfg.hybrid_period):
                x = mamba(x, i)
            return _dense_block_fwd(params["shared"], x, cfg, None)

        n_units = cfg.n_layers // cfg.hybrid_period
        hybrid_unit, tail = _remat(hybrid_unit, remat), _remat(mamba, remat)
        for u in range(n_units):
            x = hybrid_unit(x, u)
        for i in range(n_units * cfg.hybrid_period, cfg.n_layers):
            x = tail(x, i)
        return L.apply_norm(params["final_norm"], x, cfg)
    windows = _layer_windows(cfg)

    def block(x, i):
        p = layer_params(params["blocks"], i)
        x = constrain(x, "batch", None, None)  # the residual stream, as the reference pins it
        if cfg.family == "ssm":
            x = x + S.rwkv_time_mix(p["time_mix"], L.apply_norm(p["ln1"], x, cfg), cfg)
            return x + S.rwkv_channel_mix(p["channel_mix"], L.apply_norm(p["ln2"], x, cfg), cfg)
        return _dense_block_fwd(p, x, cfg, windows[i])

    block = _remat(block, remat)
    for i in range(cfg.n_layers):
        x = block(x, i)
    return L.apply_norm(params["final_norm"], x, cfg)


def _head(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """The output head ``(D, V)`` in the compute dtype: the tied embedding's
    transpose or ``lm_head``'s weight, a ``DTensor`` gathered over its fsdp
    dim (the table before its transpose: a transposed share's gradient is
    not contiguous)."""
    if cfg.tie_embeddings:
        return gather_fsdp(params["embed"].to(_dtype(cfg))).T
    return gather_fsdp(params["lm_head"]["w"].to(_dtype(cfg)))


def logits_for_position(cfg: ModelConfig, params: Params,
                        hidden_last: torch.Tensor) -> torch.Tensor:
    """``(B, D) -> (B, V)`` fp32 logits; the padded vocabulary is -1e30.

    The reference multiplies in the compute dtype with fp32 results
    (``preferred_element_type``); here the bf16 operands are widened to fp32
    first, which gives the same exact products, summed in fp32."""
    dtype = _dtype(cfg)
    logits = hidden_last.to(dtype).float() @ _head(cfg, params).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(mask[None, :], logits, -1e30)


def _ce_chunk(cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor,
              w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One sequence chunk's summed NLL and count of valid labels: fp32
    logits of ``h: (B, C, D)`` against ``w: (D, V)`` (both in the compute
    dtype, widened to fp32: exact products summed in fp32), the final
    softcap, the padded vocabulary at -1e30, logsumexp less the gold logit
    where the label is >= 0."""
    logits = constrain(h.float() @ w.float(), "batch", None, "vocab")
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    vocab = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    logits = torch.where(vocab, logits, -1e30)
    if is_dtensor(logits):
        lse, gold = _lse_gold_sharded(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    valid = (labels >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _lse_gold_sharded(logits: torch.Tensor, labels: torch.Tensor):
    """``(logsumexp, gold logit)`` of vocab-sharded ``logits`` without
    gathering them: the max and the sum of exponentials reduce over the
    vocab shards, and each rank picks the gold logits its shard holds
    (``local_map``; zero elsewhere, a partial sum over the shards).  With
    one vocab shard, the unsharded ``logsumexp`` and gather on each rank's
    rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, places = logits.device_mesh, tuple(logits.placements)
    rows = tuple(Replicate() if q == Shard(2) else q for q in places)
    vocab_dims = [d for d, q in enumerate(places) if q == Shard(2)]
    if math.prod(dim_sizes(mesh)[d] for d in vocab_dims) == 1:
        # one vocab shard (a mesh of one rank): the unsharded arithmetic
        def whole(lg, lab):
            lse = torch.logsumexp(lg, dim=-1)
            return lse, torch.gather(lg, -1, lab.clamp(min=0)[..., None].long())[..., 0]

        return local_map(whole, out_placements=(rows, rows), in_placements=(places, rows),
                         device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    gold_places = tuple(Partial() if q == Shard(2) else q for q in places)

    def pick(lg, lab):
        coord, sizes = mesh.get_coordinate(), dim_sizes(mesh)
        n, i = 1, 0
        for d in vocab_dims:
            n, i = n * sizes[d], i * sizes[d] + coord[d]
        lo = i * lg.shape[-1]
        at = lab.clamp(min=0).long() - lo
        hit = (at >= 0) & (at < lg.shape[-1])
        got = torch.gather(lg, -1, at.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return (torch.where(hit, got, torch.zeros((), dtype=lg.dtype, device=lg.device)),)

    gold, = local_map(pick, out_placements=(gold_places,), in_placements=(places, rows),
                      device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return lse, gold


def chunked_ce_loss(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``hidden: (B, S, D)`` (compute
    dtype) against ``labels: (B, S)`` without holding ``(B, S, V)`` logits:
    the sequence padded to a multiple of ``vocab_chunk`` with label -1, one
    chunk at a time, each chunk's logits dropped after its forward and
    recomputed in the backward; sums in fp32, chunk by chunk in order, as the
    reference's scan."""
    b, s, _ = hidden.shape
    # rows over the batch axes, whole over the tensor axis, so that each
    # chunk's product leaves its logits vocab-sharded (DTensor would
    # otherwise keep rows spread over the tensor axis and gather the head)
    hidden = constrain(hidden, "batch", None, None)
    w = _head(cfg, params)
    chunk = min(cfg.vocab_chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    hp = F.pad(hidden, (0, 0, 0, pad)) if pad else hidden
    lp = F.pad(labels, (0, pad), value=-1) if pad else labels
    part = _remat(lambda h, lab, w: _ce_chunk(cfg, h, lab, w), True)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        nll, valid = part(hp[:, i * chunk:(i + 1) * chunk], lp[:, i * chunk:(i + 1) * chunk], w)
        tot, cnt = tot + nll, cnt + valid
    return tot / torch.clamp(cnt, min=1.0)
