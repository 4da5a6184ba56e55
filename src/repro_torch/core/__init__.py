from . import engine, frank_wolfe, low_rank, power_method, tasks, trace_norm
from .frank_wolfe import FitResult, fit

__all__ = [
    "engine", "frank_wolfe", "low_rank", "power_method", "tasks", "trace_norm",
    "FitResult", "fit",
]
