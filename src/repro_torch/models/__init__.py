"""The LM stack of the port: the ``dense`` family (qwen1.5, phi4-mini,
granite, Gemma2), the ``moe`` family (OLMoE, Mixtral), the ``ssm`` family
(RWKV6) and the ``hybrid`` family (Zamba2) for serving, the counterpart of
``repro.models``."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import SHAPES, Model, ShapeSpec
from repro_torch.models import backbone, convert, decode, layers, prefill, ssm

__all__ = [
    "ModelConfig", "Model", "ShapeSpec", "SHAPES",
    "backbone", "convert", "decode", "prefill", "layers", "ssm",
]
