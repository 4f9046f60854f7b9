"""The LM stack of the port: the ``dense`` family (qwen1.5, phi4-mini,
granite, Gemma2), the ``moe`` family (OLMoE, Mixtral), the ``ssm`` family
(RWKV6), the ``hybrid`` family (Zamba2), the ``audio`` family (Whisper) and
the ``vlm`` family (Llama-3.2-Vision) for serving, the counterpart of
``repro.models``."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import SHAPES, Model, ShapeSpec, input_specs
from repro_torch.models import backbone, convert, decode, layers, prefill, ssm

__all__ = [
    "ModelConfig", "Model", "ShapeSpec", "SHAPES", "input_specs",
    "backbone", "convert", "decode", "prefill", "layers", "ssm",
]
