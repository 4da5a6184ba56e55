"""Hand-written Hopper kernels of the port, one subpackage per kernel:

    kernel.py  ctypes binding of the CUDA source in ``repro_torch/csrc``
    ops.py     public wrapper: checks, launch counter, CPU -> plain version
    ref.py     plain PyTorch version (CPU tests, on-card comparisons)

``_build.py`` compiles the sources on first use; importing this package
compiles nothing.
"""
from . import (factor_matvec, flash_attention, mc_matvec, power_matvec, quantize, rank1_update,
               wkv6_chunk)

#: Every kernel wrapper with a ``launches`` counter, by name.
WRAPPERS = {
    "matvec": power_matvec.ops.matvec,
    "rmatvec": power_matvec.ops.rmatvec,
    "rank1_update": rank1_update.ops.rank1_update,
    "rank1_update_axpy": rank1_update.ops.rank1_update_axpy,
    "coo_matvec": mc_matvec.ops.coo_matvec,
    # one a call: a one-field gather, or an order's copies when a state is built
    "gather_sorted": mc_matvec.ops.gather_sorted,
    "update_resid": mc_matvec.ops.update_resid,
    "quantize": quantize.ops.quantize,
    "dequantize": quantize.ops.dequantize,
    "factor_matvec": factor_matvec.ops.factor_matvec,
    "flash_attention": flash_attention.ops.flash_attention,
    "wkv6_chunk": wkv6_chunk.ops.wkv6_chunk,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def route_launches() -> dict:
    """Launches by route, for the wrappers with more than one kernel."""
    return {name: dict(fn.route_launches) for name, fn in WRAPPERS.items()
            if hasattr(fn, "route_launches")}


__all__ = ["factor_matvec", "flash_attention", "mc_matvec", "power_matvec", "quantize",
           "rank1_update", "wkv6_chunk", "WRAPPERS", "reset_launches", "launches",
           "route_launches"]
