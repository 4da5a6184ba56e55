from . import kernel, ops, ref
from .ops import matmat, matvec, power_iter_step, rmatmat, rmatvec

__all__ = ["kernel", "ops", "ref", "matvec", "rmatvec", "matmat", "rmatmat", "power_iter_step"]
