from . import kernel, ops, ref
from .ops import matvec, rmatvec

__all__ = ["kernel", "ops", "ref", "matvec", "rmatvec"]
