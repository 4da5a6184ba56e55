from . import kernel, ops, ref
from .ops import factor_matvec

__all__ = ["kernel", "ops", "ref", "factor_matvec"]
