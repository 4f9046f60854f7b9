"""rwkv6-1.6b — Finch: attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    attn_free=True, use_rope=False, norm="layernorm",
)
