from . import kernel, ops, ref
from .ops import flash_attention

__all__ = ["kernel", "ops", "ref", "flash_attention"]
