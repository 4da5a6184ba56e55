"""Hand-written Hopper kernels of the port, one subpackage per kernel:

    kernel.py  ctypes binding of the CUDA source in ``repro_torch/csrc``
    ops.py     public wrapper: checks, launch counter, CPU -> plain version
    ref.py     plain PyTorch version (CPU tests, on-card comparisons)

``_build.py`` compiles the sources on first use; importing this package
compiles nothing.
"""
from . import mc_matvec, power_matvec, quantize, rank1_update

#: Every kernel wrapper with a ``launches`` counter, by name.
WRAPPERS = {
    "matvec": power_matvec.ops.matvec,
    "rmatvec": power_matvec.ops.rmatvec,
    "rank1_update": rank1_update.ops.rank1_update,
    "rank1_update_axpy": rank1_update.ops.rank1_update_axpy,
    "coo_matvec": mc_matvec.ops.coo_matvec,
    "quantize": quantize.ops.quantize,
    "dequantize": quantize.ops.dequantize,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["mc_matvec", "power_matvec", "quantize", "rank1_update", "WRAPPERS",
           "reset_launches", "launches"]
