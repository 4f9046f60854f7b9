"""llama-3.2-vision-11b — cross-attn image layers (backbone only; the vision
encoder is a stub: input_specs supplies precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    rope_theta=500000.0, cross_attn_period=5, vision_tokens=1601,
)
