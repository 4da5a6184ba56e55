from . import kernel, ops, ref
from .ops import matmat, matvec, rmatmat, rmatvec

__all__ = ["kernel", "ops", "ref", "matvec", "rmatvec", "matmat", "rmatmat"]
