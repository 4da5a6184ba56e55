"""Factor-form serving: score requests straight from the factored iterate.

``engine.ServingEngine`` (padded static batches, rank buckets, hot-swap from
run checkpoints) and ``batcher.MicroBatcher`` (single requests gathered into
engine dispatches).
"""
from . import batcher, engine
from .batcher import MicroBatcher, Ticket
from .engine import (
    Model,
    PendingScores,
    ServeConfig,
    ServingEngine,
    rank_bucket,
    verify_factor_kernels,
)

__all__ = [
    "MicroBatcher",
    "Model",
    "PendingScores",
    "ServeConfig",
    "ServingEngine",
    "Ticket",
    "batcher",
    "engine",
    "rank_bucket",
    "verify_factor_kernels",
]
