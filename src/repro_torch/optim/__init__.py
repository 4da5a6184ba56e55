"""Optimizer-side substrates, the port's counterpart of ``repro.optim``.

``compression`` (PowerSGD low-rank gradient compression with error
feedback) is ported. ``adamw``, ``schedule`` and ``hybrid`` belong to LM
training, which is not yet ported: importing them raises ``NotYetPorted``.
"""
from ..specs import NotYetPorted
from . import compression
from .compression import PowerSGDState

_UNPORTED = ("adamw", "schedule", "hybrid", "AdamWState")

__all__ = ["compression", "PowerSGDState"]


def __getattr__(name):
    if name in _UNPORTED:
        raise NotYetPorted(f"repro_torch.optim.{name} (LM training) is not yet ported to "
                           "PyTorch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
