"""Model configuration for the assigned architecture pool.

One frozen dataclass describes every family (dense / MoE / SSM / hybrid /
enc-dec / VLM); the backbone assembles the right block pattern from it.

The port's own copy of ``repro.models.config`` (pure Python, field for
field), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int | None = None  # SWA window (Mixtral)
    local_global: bool = False  # Gemma2 alternating local/global
    local_window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None

    # ffn
    mlp: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False
    embed_scale: bool = False  # Gemma: embeddings * sqrt(d_model)
    sandwich_norm: bool = False  # Gemma2: post-block norms too
    learned_pos: bool = False  # Whisper: learned absolute positions
    max_learned_pos: int = 32768

    # moe
    n_experts: int = 0
    top_k_experts: int = 0
    capacity_factor: float = 1.25

    # ssm / rwkv
    attn_free: bool = False  # rwkv6
    ssm_state: int = 0  # mamba2 state size N
    ssm_conv: int = 4  # depthwise conv width
    ssm_expand: int = 2  # mamba inner expansion
    hybrid_period: int = 0  # zamba2: shared attn every N mamba blocks

    # enc-dec (whisper) / cross-attn VLM (llama-3.2-vision)
    encoder_layers: int = 0
    encoder_seq: int = 0  # whisper: 1500 precomputed frames (conv stub)
    cross_attn_period: int = 0  # llama-vision: every 5th layer is cross-attn
    vision_tokens: int = 0  # precomputed patch embeddings (stub)

    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    vocab_chunk: int = 2048  # chunked-CE logits block (memory bound)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding to a multiple of 256 so the vocab
        dim shards over any tensor axis; padded logits are masked in the
        loss (see backbone.chunked_ce_loss)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch admits 500k-token decode per the brief's rule:
        SSM/hybrid/linear-attn families and windowed-attention archs."""
        return (
            self.attn_free
            or self.ssm_state > 0
            or self.sliding_window is not None
            or self.local_global
        )

    # -- parameter counting (for 6*N*D model-flops and memory estimates) ---
    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += d * v  # lm head

        def attn_params(kv_heads: int) -> int:
            p = d * self.q_dim + 2 * d * (kv_heads * self.head_dim) + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * kv_heads * self.head_dim
            return p

        def mlp_params() -> int:
            if self.mlp in ("swiglu", "geglu"):
                return 3 * d * f
            return 2 * d * f

        def moe_params() -> int:
            return self.n_experts * 3 * d * f + d * self.n_experts

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,w,o projections + decay lora + channel mix
            return 6 * d * d + 2 * d * 64 + 3 * d * f

        def mamba_params() -> int:
            inner = self.ssm_expand * d
            # in-proj (x,z), dt/B/C proj, out proj, conv, D, A
            return d * 2 * inner + inner * (2 * self.ssm_state + self.n_heads) + inner * d + self.ssm_conv * inner + 2 * inner

        per_layer_norms = 2 * d
        if self.family == "moe":
            block = attn_params(self.n_kv_heads) + moe_params() + per_layer_norms
            n += self.n_layers * block
        elif self.attn_free:
            n += self.n_layers * (rwkv_params() + per_layer_norms)
        elif self.ssm_state > 0 and self.hybrid_period:
            n += self.n_layers * (mamba_params() + per_layer_norms)
            n += attn_params(self.n_kv_heads) + mlp_params() + per_layer_norms  # shared block
        elif self.is_encdec:
            dec_block = attn_params(self.n_kv_heads) * 2 + mlp_params() + 3 * d
            enc_block = attn_params(self.n_kv_heads) + mlp_params() + per_layer_norms
            n += self.n_layers * dec_block + self.encoder_layers * enc_block
            n += (self.encoder_seq + 8192) * d  # learned positions (enc+dec)
        elif self.cross_attn_period:
            n_cross = self.n_layers // self.cross_attn_period
            n_self = self.n_layers - n_cross
            block = attn_params(self.n_kv_heads) + mlp_params() + per_layer_norms
            n += n_self * block + n_cross * (block + d)  # + gate
        else:
            n += self.n_layers * (attn_params(self.n_kv_heads) + mlp_params() + per_layer_norms)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of E experts)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        moe_total = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        moe_active = self.n_layers * self.top_k_experts * 3 * self.d_model * self.d_ff
        return full - moe_total + moe_active
