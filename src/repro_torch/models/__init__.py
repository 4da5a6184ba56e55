"""The LM zoo's dense family on PyTorch (``repro.models`` in the reference)."""
from . import config, layers, lm
from .config import LM_SHAPES, ModelConfig, ShapeSpec, applicable_shapes

__all__ = ["config", "layers", "lm", "LM_SHAPES", "ModelConfig", "ShapeSpec",
           "applicable_shapes"]
