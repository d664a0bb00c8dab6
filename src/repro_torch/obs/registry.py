"""Host-side metrics registry: counters / gauges / histograms with labels.

A copy of ``repro.obs.registry``, kept so the port never imports the JAX
package.

One process-wide (or per-harness) ``MetricsRegistry`` owns every metric;
components take an optional ``metrics=None`` argument and do *zero* work
when it is absent — the default-off path allocates nothing and transfers
nothing off-device.  When enabled, per-wave records land in a fixed-
capacity ring buffer written by the single harvest thread (appends under
the GIL are atomic; there is no lock, and readers snapshot by index so a
concurrent scrape never blocks the wave path).

Export formats:

* ``snapshot()``      — plain dict, one entry per (metric, labelset);
* ``to_jsonl(path)``  — one JSON object per line, ready for artifact
  upload / offline diffing;
* ``prometheus_text()`` — text exposition format (counters as
  ``_total``, histograms as cumulative ``_bucket{le=...}`` + ``_sum`` +
  ``_count``), scrapeable by anything that speaks Prometheus.

Label sets are small and explicit (``kind="insert"``), normalised to a
sorted tuple so ``{a=1,b=2}`` and ``{b=2,a=1}`` are the same series.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _labelstr(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonically increasing count, one series per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        key = _labelkey(labels)
        self._series[key] = self._series.get(key, 0.0) + float(value)

    def value(self, **labels: Any) -> float:
        return self._series.get(_labelkey(labels), 0.0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._series)


class Gauge:
    """Last-set value; ``set_max`` keeps a high-water mark instead."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        self._series[_labelkey(labels)] = float(value)

    def set_max(self, value: float, **labels: Any) -> None:
        key = _labelkey(labels)
        cur = self._series.get(key)
        if cur is None or value > cur:
            self._series[key] = float(value)

    def value(self, **labels: Any) -> float:
        return self._series.get(_labelkey(labels), 0.0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._series)


@dataclass
class _HistSeries:
    counts: List[float]
    total: float = 0.0
    n: float = 0.0


class Histogram:
    """Fixed-bucket histogram; buckets are inclusive upper edges.

    ``observe`` records one sample; ``observe_counts`` folds a whole
    per-bucket count vector in one call — that is how a device-computed
    kick-depth histogram (already binned on the accelerator) merges into
    the host registry without being unbinned.
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = "") -> None:
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self._series: Dict[LabelKey, _HistSeries] = {}

    def _get(self, labels: Dict[str, Any]) -> _HistSeries:
        key = _labelkey(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries([0.0] * (len(self.buckets)
                                                         + 1))
        return s

    def observe(self, value: float, **labels: Any) -> None:
        s = self._get(labels)
        value = float(value)
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                s.counts[i] += 1.0
                break
        else:
            s.counts[-1] += 1.0
        s.total += value
        s.n += 1.0

    def observe_counts(self, counts: Sequence[float],
                       **labels: Any) -> None:
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"{self.name}: expected {len(self.buckets) + 1} bucket "
                f"counts, got {len(counts)}")
        s = self._get(labels)
        for i, c in enumerate(counts):
            s.counts[i] += float(c)
        # Bucket midpoint proxy for the sum: device planes only ship
        # counts, so the _sum series is approximate there (documented).
        edges = self.buckets + (self.buckets[-1],)
        s.total += sum(float(c) * edges[i] for i, c in enumerate(counts))
        s.n += sum(float(c) for c in counts)

    def series(self) -> Dict[LabelKey, _HistSeries]:
        return dict(self._series)


class RingBuffer:
    """Fixed-capacity per-wave record ring, single writer, lock-free.

    The harvest thread is the only writer; ``append`` is one list store
    plus one integer bump (each atomic under the GIL), so the wave path
    never takes a lock.  Readers copy out by index — a torn read can at
    worst see a record twice across two snapshots, never a half-written
    record.
    """

    def __init__(self, capacity: int = 1024) -> None:
        self.capacity = int(capacity)
        self._buf: List[Optional[dict]] = [None] * self.capacity
        self._n = 0  # total appends ever

    def append(self, record: dict) -> None:
        self._buf[self._n % self.capacity] = record
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def records(self) -> List[dict]:
        n = self._n
        if n <= self.capacity:
            out = self._buf[:n]
        else:
            i = n % self.capacity
            out = self._buf[i:] + self._buf[:i]
        return [r for r in out if r is not None]


class MetricsRegistry:
    """Namespace of metrics + the per-wave ring buffer."""

    def __init__(self, *, ring_capacity: int = 1024) -> None:
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()  # registration only, never the hot path
        self.ring = RingBuffer(ring_capacity)

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        h = self._register(name, lambda: Histogram(name, buckets, help),
                           Histogram)
        if h.buckets != tuple(float(b) for b in buckets):
            raise ValueError(f"{name}: histogram re-registered with "
                             f"different buckets")
        return h

    def _register(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(f"{name}: already registered as "
                                f"{type(m).__name__}")
            return m

    def record_wave(self, record: dict) -> None:
        self.ring.append(record)

    # -- export ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                for key, s in sorted(m.series().items()):
                    out[name + _labelstr(key)] = {
                        "buckets": list(m.buckets), "counts": list(s.counts),
                        "sum": s.total, "count": s.n}
            else:
                for key, v in sorted(m.series().items()):
                    out[name + _labelstr(key)] = v
        return out

    def to_jsonl(self, path: str) -> None:
        ts = time.time()
        with open(path, "w") as f:
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Histogram):
                    for key, s in sorted(m.series().items()):
                        f.write(json.dumps({
                            "ts": ts, "metric": name, "type": m.kind,
                            "labels": dict(key),
                            "buckets": list(m.buckets),
                            "counts": list(s.counts),
                            "sum": s.total, "count": s.n}) + "\n")
                else:
                    for key, v in sorted(m.series().items()):
                        f.write(json.dumps({
                            "ts": ts, "metric": name, "type": m.kind,
                            "labels": dict(key), "value": v}) + "\n")
            for rec in self.ring.records():
                f.write(json.dumps({"ts": ts, "type": "wave",
                                    "record": rec}) + "\n")

    def prometheus_text(self) -> str:
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, s in sorted(m.series().items()):
                    cum = 0.0
                    for i, edge in enumerate(m.buckets):
                        cum += s.counts[i]
                        lk = key + (("le", repr(edge)),)
                        lines.append(f"{name}_bucket{_labelstr(lk)} {cum}")
                    cum += s.counts[-1]
                    lk = key + (("le", "+Inf"),)
                    lines.append(f"{name}_bucket{_labelstr(lk)} {cum}")
                    lines.append(f"{name}_sum{_labelstr(key)} {s.total}")
                    lines.append(f"{name}_count{_labelstr(key)} {s.n}")
            else:
                suffix = "_total" if isinstance(m, Counter) else ""
                for key, v in sorted(m.series().items()):
                    lines.append(f"{name}{suffix}{_labelstr(key)} {v}")
        return "\n".join(lines) + "\n"


__all__ = ["Counter", "Gauge", "Histogram", "RingBuffer",
           "MetricsRegistry"]
