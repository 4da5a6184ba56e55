"""DFW-Trace, the paper's contribution, as the port's library.

Public surface:
    frank_wolfe.fit / make_epoch_step   DFW-Trace (paper Alg. 2)
    power_method.power_iterations       the distributed power method
    baselines.make_naive_epoch_step     NAIVE-DFW (paper §3.1)
    baselines.make_sva_epoch_step       Singular Vector Averaging (§3.1)
    tasks.MultiTaskLeastSquares[Dense]  paper §2.3 / App. B
    tasks.MultinomialLogistic           paper §2.3 / App. B
    tasks.MatrixCompletion              paper §2.3 / App. B (sparse Omega)
    low_rank.FactoredIterate            the O(t(d+m)) iterate store (§2.2)
    dfw_head.train_head / sharded_fit   a trace-norm head on a backbone's
                                        features (the ImageNet experiment)
"""
from . import baselines, dfw_head, engine, frank_wolfe, low_rank, power_method, tasks, trace_norm
from .frank_wolfe import FitResult, fit
from .power_method import sphere_vector, top_singular_pair

__all__ = [
    "baselines", "dfw_head", "engine", "frank_wolfe", "low_rank", "power_method", "tasks",
    "trace_norm", "FitResult", "fit", "sphere_vector", "top_singular_pair",
]
