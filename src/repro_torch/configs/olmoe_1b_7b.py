"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    n_experts=64, top_k_experts=8,
)
