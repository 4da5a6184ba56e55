"""The LM zoo's dense and ssm families on PyTorch (``repro.models`` in the reference)."""
from . import config, layers, lm, rwkv6
from .config import LM_SHAPES, ModelConfig, ShapeSpec, applicable_shapes

__all__ = ["config", "layers", "lm", "rwkv6", "LM_SHAPES", "ModelConfig", "ShapeSpec",
           "applicable_shapes"]
