from . import kernel, ops, ref
from .ops import SegmentOrder, build_order, coo_matvec, gather_sorted, update_resid

__all__ = ["kernel", "ops", "ref", "SegmentOrder", "build_order", "coo_matvec", "gather_sorted",
           "update_resid"]
