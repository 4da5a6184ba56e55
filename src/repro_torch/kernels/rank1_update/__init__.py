from . import kernel, ops, ref
from .ops import rank1_update, rank1_update_axpy, rankk_update, rankk_update_axpy

__all__ = ["kernel", "ops", "ref", "rank1_update", "rank1_update_axpy", "rankk_update",
           "rankk_update_axpy"]
