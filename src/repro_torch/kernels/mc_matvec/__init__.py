from . import kernel, ops, ref
from .ops import (SegmentOrder, build_order, build_order_with_copies, coo_matvec, gather_sorted,
                  gather_sorted_fields, update_resid)

__all__ = ["kernel", "ops", "ref", "SegmentOrder", "build_order", "build_order_with_copies",
           "coo_matvec", "gather_sorted", "gather_sorted_fields", "update_resid"]
