from . import kernel, ops, ref
from .ops import wkv6_chunk

__all__ = ["kernel", "ops", "ref", "wkv6_chunk"]
