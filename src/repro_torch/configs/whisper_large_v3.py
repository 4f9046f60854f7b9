"""whisper-large-v3 — enc-dec; conv/audio frontend is a stub (input_specs
supplies precomputed 1500-frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_seq=1500,
    mlp="gelu", norm="layernorm", use_rope=False, learned_pos=True,
)
