"""The LM zoo on PyTorch: the dense, ssm, audio, vlm and hybrid families (``repro.models`` in
the reference)."""
from . import config, layers, lm, mamba2, rwkv6
from .config import LM_SHAPES, ModelConfig, ShapeSpec, applicable_shapes

__all__ = ["config", "layers", "lm", "mamba2", "rwkv6", "LM_SHAPES", "ModelConfig", "ShapeSpec",
           "applicable_shapes"]
