from . import kernel, ops, ref
from .ops import dequantize, quantize

__all__ = ["kernel", "ops", "ref", "quantize", "dequantize"]
