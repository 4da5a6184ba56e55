"""Optimizer-side substrates, the port's counterpart of ``repro.optim``:
``adamw`` (AdamW from the reference's formula), ``schedule`` (learning-rate
schedules), ``hybrid`` (AdamW on the backbone, DFW-Trace Frank-Wolfe steps
on the unembedding head) and ``compression`` (PowerSGD low-rank gradient
compression with error feedback).
"""
from . import adamw, compression, hybrid, schedule
from .adamw import AdamWState
from .compression import PowerSGDState

__all__ = ["adamw", "compression", "hybrid", "schedule", "AdamWState", "PowerSGDState"]
