from . import baselines, engine, frank_wolfe, low_rank, power_method, tasks, trace_norm
from .frank_wolfe import FitResult, fit

__all__ = [
    "baselines", "engine", "frank_wolfe", "low_rank", "power_method", "tasks", "trace_norm",
    "FitResult", "fit",
]
