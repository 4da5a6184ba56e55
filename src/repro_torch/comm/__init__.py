from .base import DenseReducer, WorkerGroup, make_reducer, pmax, psum
from .int8 import Int8Reducer, verify_quantize_kernels

__all__ = ["DenseReducer", "Int8Reducer", "WorkerGroup", "make_reducer", "pmax", "psum",
           "verify_quantize_kernels"]
