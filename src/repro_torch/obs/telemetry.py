"""Span tracing and an event stream with JSONL and Chrome-trace sinks, the
port's copy of the JAX package's ``repro.obs.telemetry``.

A :class:`Telemetry` handle is the one object threaded through
``DFWConfig``, ``frank_wolfe.fit``, the engine, the checkpoint store and
``ServeConfig``. It owns

* a :class:`~repro_torch.obs.registry.MetricsRegistry` (aggregates),
* a bounded in-memory event stream (the timeline), and
* the sinks: ``write_jsonl`` (one JSON object per line) and
  ``write_chrome_trace`` (a ``chrome://tracing`` / Perfetto trace), plus
  ``profiler()``, which brackets a region with ``torch.profiler`` and
  writes its device-level Chrome trace to ``profiler_dir``.

No host sync: nothing in this module touches a device value. The callers
hand in host scalars they already hold: the engine's per-epoch scalars come
from the rows its boundary fetches already copy, the comm bytes are
analytic or read from a program's op log once per capture, and checkpoint
latency is stamped on the writer thread. Nothing is recorded inside a
captured CUDA graph: every record is made on the host around a replay and
its fetches. The disabled handle (``Telemetry.noop()``) records nothing and
allocates nothing per call; :func:`noop_contract` pins its cost.

Events are Chrome trace-event dicts (ph "X" complete spans, "i" instants,
"C" counter samples), so both sinks write the same dicts; timestamps are
microseconds since the handle was made (``time.perf_counter``). This module
imports only the standard library; ``profiler()`` imports torch when it
runs.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .registry import MetricsRegistry

__all__ = ["Telemetry", "noop_contract"]


class _NullSpan:
    """Shared do-nothing span returned by a disabled handle."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting one ph="X" complete event on exit."""

    __slots__ = ("_tel", "_name", "_cat", "_t0", "_args")

    def __init__(self, tel: "Telemetry", name: str, cat: str,
                 t0: Optional[float], args: Dict[str, Any]):
        self._tel = tel
        self._name = name
        self._cat = cat
        self._t0 = t0
        self._args = args

    def __enter__(self):
        if self._t0 is None:
            self._t0 = self._tel.now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tel.complete(self._name, self._cat, self._t0,
                           self._tel.now_us() - self._t0, **self._args)
        return False


class Telemetry:
    """Run-wide telemetry handle (metrics registry, event stream, sinks).

    Parameters
    ----------
    enabled:
        When False the handle is inert: every record call is a cheap
        no-op, ``span()`` returns a shared null context manager and the
        event stream stays empty. ``Telemetry.noop()`` returns a shared
        handle built this way.
    capture_hlo:
        The reference's name, kept so that callers' code runs unchanged.
        Here it lets the engine and the serving engine record each program
        they capture into a CUDA graph (on the CPU, or uncaptured: its first
        run) under ``analysis.recorder.OpRecorder``, once per program, and
        emit what its op log shows (collectives by kind and bytes, output
        shapes) as ``comm.executable`` / ``serve.executable`` events.
        ``wants_hlo`` keeps its name too.
    max_events:
        Hard cap on the in-memory stream; past it events are counted as
        dropped rather than appended.
    profiler_dir:
        When set, ``profiler()`` brackets its region with
        ``torch.profiler.profile`` (CPU and, with a card, CUDA activity) and
        writes the profiler's Chrome trace into this directory
        (``trace_<pid>_<n>.json``; the paths written are in
        ``profiler_traces``); when None the bracket does nothing.
    """

    def __init__(self, enabled: bool = True, *, capture_hlo: bool = True,
                 max_events: int = 200_000,
                 profiler_dir: Optional[str] = None):
        self.enabled = bool(enabled)
        self.capture_hlo = bool(capture_hlo)
        self.max_events = int(max_events)
        self.profiler_dir = profiler_dir
        self.profiler_traces: List[str] = []
        self.registry = MetricsRegistry()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._lock = threading.Lock()  # the checkpoint writer thread records too
        self._pid = os.getpid()
        self._t0_perf = time.perf_counter()
        self._t0_unix = time.time()

    # -- time ---------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since this handle was made (monotonic)."""
        return (time.perf_counter() - self._t0_perf) * 1e6

    # -- recording ----------------------------------------------------------

    @property
    def wants_hlo(self) -> bool:
        """Record each captured program's op log (see ``capture_hlo``)."""
        return self.enabled and self.capture_hlo

    def _append(self, ev: Dict[str, Any]) -> None:
        # list.append is atomic under the GIL, which is all the checkpoint
        # writer thread needs; the cap check races benignly (a burst can
        # pass max_events by one event a thread).
        if len(self._events) < self.max_events:
            self._events.append(ev)
        else:
            with self._lock:
                self._dropped += 1

    def span(self, name: str, cat: str = "run",
             t0: Optional[float] = None, **args: Any):
        """Context manager producing a complete ("X") event on exit.

        ``t0`` (microseconds, from :meth:`now_us`) backdates the start, for
        work that began before the handle could be consulted."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, t0, args)

    def complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                 **args: Any) -> None:
        """Record a complete span [ts_us, ts_us + dur_us] after the fact."""
        if not self.enabled:
            return
        self._append({"name": name, "cat": cat, "ph": "X",
                      "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
                      "pid": self._pid, "tid": threading.get_ident(),
                      "args": args})

    def event(self, name: str, cat: str = "run",
              ts_us: Optional[float] = None, **args: Any) -> None:
        """Record an instant ("i") event, e.g. early_stop or hot_swap."""
        if not self.enabled:
            return
        self._append({"name": name, "cat": cat, "ph": "i", "s": "t",
                      "ts": round(self.now_us() if ts_us is None else ts_us, 3),
                      "pid": self._pid, "tid": threading.get_ident(),
                      "args": args})

    def counter_sample(self, name: str, value: float, cat: str = "metrics",
                       ts_us: Optional[float] = None) -> None:
        """Record a ph="C" counter sample (a track in Perfetto)."""
        if not self.enabled:
            return
        self._append({"name": name, "cat": cat, "ph": "C",
                      "ts": round(self.now_us() if ts_us is None else ts_us, 3),
                      "pid": self._pid, "tid": 0,
                      "args": {"value": value}})

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        """Copy of the event stream (Chrome trace-event dicts)."""
        with self._lock:
            return list(self._events)

    # -- torch.profiler bracket ----------------------------------------------

    @contextmanager
    def profiler(self):
        """Bracket a region with ``torch.profiler`` when ``profiler_dir`` is
        set, and write its Chrome trace there on exit."""
        if not (self.enabled and self.profiler_dir):
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profiler_dir, exist_ok=True)
        path = os.path.join(self.profiler_dir,
                            f"trace_{self._pid}_{len(self.profiler_traces)}.json")
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(path)
        self.profiler_traces.append(path)

    # -- sinks --------------------------------------------------------------

    def _meta(self) -> Dict[str, Any]:
        return {"type": "meta", "t0_unix": self._t0_unix, "pid": self._pid,
                "clock": "us_since_start", "dropped_events": self._dropped,
                "max_events": self.max_events}

    def write_jsonl(self, path) -> None:
        """One JSON object per line: meta, then the events, then a final
        ``{"type": "metrics", ...}`` registry snapshot."""
        events = self.events()
        with open(path, "w") as fh:
            fh.write(json.dumps(self._meta()) + "\n")
            for ev in events:
                fh.write(json.dumps(ev) + "\n")
            fh.write(json.dumps({"type": "metrics",
                                 "data": self.registry.snapshot()}) + "\n")

    def write_chrome_trace(self, path) -> None:
        """Chrome trace JSON (open in Perfetto or chrome://tracing)."""
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"meta": self._meta(),
                          "metrics": self.registry.snapshot()},
        }
        with open(path, "w") as fh:
            json.dump(doc, fh)

    # -- no-op handle ---------------------------------------------------------

    _NOOP: Optional["Telemetry"] = None

    @classmethod
    def noop(cls) -> "Telemetry":
        """The shared inert handle, the default wherever a Telemetry is
        taken. Records nothing; its per-span cost is pinned by
        :func:`noop_contract`."""
        if cls._NOOP is None:
            cls._NOOP = cls(enabled=False, capture_hlo=False, max_events=0)
        return cls._NOOP


def noop_contract():
    """The contract of the disabled handle: a span costs under 50 us to
    enter and leave, and the event stream stays empty
    (``analysis.contracts.verify_declared`` checks it)."""
    from ..analysis.contracts import Contract

    return Contract(name="obs.noop_overhead", max_noop_span_us=50.0,
                    max_events=0)
