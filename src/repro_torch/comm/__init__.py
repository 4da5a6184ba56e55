from .base import DenseReducer, make_reducer, pmax, psum

__all__ = ["DenseReducer", "make_reducer", "pmax", "psum"]
