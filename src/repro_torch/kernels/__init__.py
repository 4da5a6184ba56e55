"""Hand-written Hopper kernels of the port, one subpackage per kernel:

    kernel.py  ctypes binding of the CUDA source in ``repro_torch/csrc``
    ops.py     public wrapper: checks, launch counter, CPU -> plain version
    ref.py     plain PyTorch version (CPU tests, on-card comparisons)

``_build.py`` compiles the sources on first use; importing this package
compiles nothing.

A wrapper's ``launches`` counts its calls that launch its kernel. A call
made while a CUDA graph is being captured counts once, when captured, and
the graph's replays add nothing: what the device ran is counted by
:class:`Executed`, on the device (``_count.py``).
"""
from . import _count
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
    # the block:k solver's forms (update_resid's block form: its route_launches)
    "matmat": power_matvec.ops.matmat,
    "rmatmat": power_matvec.ops.rmatmat,
    "rankk_update": rank1_update.ops.rankk_update,
    "rankk_update_axpy": rank1_update.ops.rankk_update_axpy,
    "coo_matmat": mc_matvec.ops.coo_matmat,
    # the block update_resid's caller order alone (the block line search)
    "update_resid_caller": mc_matvec.ops.update_resid_caller,
    "quantize": quantize.ops.quantize,
    "dequantize": quantize.ops.dequantize,
    "factor_matvec": factor_matvec.ops.factor_matvec,
    "flash_attention": flash_attention.ops.flash_attention,
    "wkv6_chunk": wkv6_chunk.ops.wkv6_chunk,
}


class Executed:
    """The launches the device ran inside a ``with`` block, graph replays
    and IF-node bodies included.

    While the block is open, every wrapper's launch on ``device`` (default:
    the current CUDA device) also adds one to a counter on the device,
    right after its kernel (``_count.launched``): a graph captured inside
    counts each launch each time it runs, and nothing where an IF node
    skipped its body. The counters cost one small kernel a launch. On exit
    (after a synchronize): ``launches`` maps every wrapper to its count and
    ``routes`` the routed wrappers' routes, as ``launches()`` and
    ``route_launches()`` do for the calls."""

    def __init__(self, device=None):
        import torch

        self.device = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)

    def __enter__(self) -> "Executed":
        import torch

        slots = {}
        for fn in WRAPPERS.values():
            slots[id(fn), None] = len(slots)
            for route in getattr(fn, "route_launches", {}):
                slots[id(fn), route] = len(slots)
        self._slots = slots
        if _count.ACTIVE is not None:
            raise RuntimeError("an Executed block is open already")
        self._counts = torch.zeros(len(slots), dtype=torch.int64, device=self.device)
        _count.ACTIVE = (self.device, self._counts, slots)
        return self

    def __exit__(self, *exc) -> None:
        import torch

        _count.ACTIVE = None
        if exc[0] is not None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        counts = self._counts.tolist()
        self.launches = {name: counts[self._slots[id(fn), None]] for name, fn in WRAPPERS.items()}
        self.routes = {name: {r: counts[self._slots[id(fn), r]] for r in fn.route_launches}
                       for name, fn in WRAPPERS.items() if hasattr(fn, "route_launches")}


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
           "rank1_update", "wkv6_chunk", "WRAPPERS", "Executed", "reset_launches", "launches",
           "route_launches"]
