"""Trace spans: Chrome trace-event JSON, loadable in Perfetto.

A copy of ``repro.obs.trace``, kept so the port never imports the JAX
package.

``TraceRecorder.span("harvest", kind="insert")`` wraps any region in a
complete-event (``ph: "X"``) with microsecond timestamps; ``instant``
drops a point marker.  ``save(path)`` writes the standard
``{"traceEvents": [...]}`` envelope — open it at https://ui.perfetto.dev
or ``chrome://tracing``.

When ``torch_profiler=True`` each span also enters a
``torch.profiler.record_function`` so the same names show up inside a
``torch.profiler`` trace of the card.

A recorder is cheap but not free (two clock reads and a dict per span),
so the serving stack only creates spans when a recorder is passed in —
``tracer=None`` keeps the hot path untouched.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, List

import torch


class TraceRecorder:
    """Collects Chrome trace events; one recorder per run/scenario."""

    def __init__(self, *, process_name: str = "repro_torch",
                 torch_profiler: bool = False,
                 clock=time.perf_counter) -> None:
        self._events: List[dict] = []
        self._clock = clock
        self._t0 = clock()
        self._pid = os.getpid()
        self._annotate = bool(torch_profiler)
        self._events.append({
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": process_name}})

    def _us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        tid = threading.get_ident() % (1 << 31)
        t0 = self._us()
        if self._annotate:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self._events.append({
            "name": name, "ph": "X", "ts": t0, "dur": self._us() - t0,
            "pid": self._pid, "tid": tid,
            "args": {k: _jsonable(v) for k, v in args.items()}})

    def instant(self, name: str, **args: Any) -> None:
        self._events.append({
            "name": name, "ph": "i", "s": "t", "ts": self._us(),
            "pid": self._pid, "tid": threading.get_ident() % (1 << 31),
            "args": {k: _jsonable(v) for k, v in args.items()}})

    def counter(self, name: str, **values: float) -> None:
        """Emit a counter event — renders as a stacked area in Perfetto."""
        self._events.append({
            "name": name, "ph": "C", "ts": self._us(), "pid": self._pid,
            "tid": 0,
            "args": {k: float(v) for k, v in values.items()}})

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms"}, f)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return float(v)  # numpy / torch scalars
    except Exception:
        return str(v)


__all__ = ["TraceRecorder"]
