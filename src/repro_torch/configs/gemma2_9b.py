"""gemma2-9b — local/global alternating attention, logit softcaps, GeGLU,
sandwich norms [arXiv:2408.00118]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    local_global=True, local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    mlp="geglu", embed_scale=True, sandwich_norm=True, tie_embeddings=True,
)
