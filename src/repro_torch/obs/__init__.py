"""repro_torch.obs: telemetry that adds no host sync (metrics, spans, trace
export), the port's copy of the JAX package's ``repro.obs``.

Public surface:

* :class:`MetricsRegistry` / :class:`Counter` / :class:`Gauge` /
  :class:`Histogram`: process-local aggregates with ``snapshot()`` and
  ``reset()``.
* :class:`Telemetry`: the handle threaded through ``DFWConfig``,
  ``frank_wolfe.fit``, the engine, ``CheckpointStore`` and ``ServeConfig``:
  spans, instant events, counter samples, JSONL and Chrome-trace sinks, a
  ``torch.profiler`` bracket. ``Telemetry.noop()`` is the inert default.
* :func:`noop_contract`: the ``analysis.contracts`` clause pinning the
  no-op handle's cost.

This package imports only the standard library (``profiler()`` imports
torch when it runs); no record reads a device value.
"""
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .telemetry import Telemetry, noop_contract

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Telemetry",
    "noop_contract",
]
