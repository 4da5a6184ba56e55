from . import kernel, ops, ref
from .ops import SegmentOrder, build_order, coo_matvec, gather_sorted

__all__ = ["kernel", "ops", "ref", "SegmentOrder", "build_order", "coo_matvec", "gather_sorted"]
