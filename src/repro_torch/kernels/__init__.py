"""Hand-written Hopper kernels of the port, one subpackage per kernel:

    kernel.py  ctypes binding of the CUDA source in ``repro_torch/csrc``
    ops.py     public wrapper: checks, launch counter, CPU -> plain version
    ref.py     plain PyTorch version (CPU tests, on-card comparisons)

``_build.py`` compiles the sources on first use; importing this package
compiles nothing.
"""
from . import power_matvec, rank1_update

#: Every kernel wrapper with a ``launches`` counter, by name.
WRAPPERS = {
    "matvec": power_matvec.ops.matvec,
    "rmatvec": power_matvec.ops.rmatvec,
    "rank1_update": rank1_update.ops.rank1_update,
    "rank1_update_axpy": rank1_update.ops.rank1_update_axpy,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["power_matvec", "rank1_update", "WRAPPERS", "reset_launches", "launches"]
