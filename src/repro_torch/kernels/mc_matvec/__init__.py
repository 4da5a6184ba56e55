from . import kernel, ops, ref
from .ops import SegmentOrder, build_order, coo_matvec

__all__ = ["kernel", "ops", "ref", "SegmentOrder", "build_order", "coo_matvec"]
