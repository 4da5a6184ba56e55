from . import kernel, ops, ref
from .ops import (SegmentOrder, build_order, build_order_with_copies, coo_matmat, coo_matvec,
                  gather_sorted, gather_sorted_fields, update_resid,
                  update_resid_caller)

__all__ = ["kernel", "ops", "ref", "SegmentOrder", "build_order", "build_order_with_copies",
           "coo_matmat", "coo_matvec", "gather_sorted", "gather_sorted_fields", "update_resid",
           "update_resid_caller"]
