"""The port's copy of the observability package (``repro_torch.obs``)
against the reference's (``repro.obs``): the same calls give the same
snapshots, exports and trace shapes.  Mirrors the registry, export, trace
and admission-counter tests of ``tests/test_obs.py``."""
import json

import pytest

from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import RecoveryMetrics as RefRecovery
from repro.obs import TraceRecorder as RefTracer
from repro.streaming.admission import AdmissionConfig as RefAdmissionConfig
from repro.streaming.admission import \
    AdmissionController as RefAdmissionController
from repro_torch.obs import MetricsRegistry, RecoveryMetrics, TraceRecorder
from repro_torch.streaming import AdmissionConfig, AdmissionController

pytestmark = pytest.mark.tier1


def _drive_registry(m):
    m.counter("c").inc(2, kind="a")
    m.counter("c").inc(kind="b")
    m.gauge("g").set(3.0)
    m.gauge("g").set_max(1.0)
    h = m.histogram("h", buckets=(1, 2, 4))
    for v in (0.5, 3, 100):
        h.observe(v)
    h.observe_counts([1, 0, 0, 0])
    return h


@pytest.mark.parametrize("registry", [MetricsRegistry, RefRegistry])
def test_registry_counter_gauge_histogram(registry):
    m = registry()
    h = _drive_registry(m)
    assert m.counter("c").value(kind="a") == 2
    assert m.gauge("g").value() == 3.0
    assert h.series()[()].counts == [2.0, 0.0, 1.0, 1.0]
    with pytest.raises(ValueError):
        m.histogram("h", buckets=(1, 2, 8))
    with pytest.raises(TypeError):
        m.gauge("c")
    with pytest.raises(ValueError):
        h.observe_counts([1, 2])


def test_registry_matches_reference():
    port, ref = MetricsRegistry(), RefRegistry()
    for m in (port, ref):
        _drive_registry(m)
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus_text() == ref.prometheus_text()


def test_registry_exports(tmp_path):
    out = {}
    for name, registry in (("port", MetricsRegistry), ("ref", RefRegistry)):
        m = registry(ring_capacity=4)
        m.counter("filter_waves").inc(3, kind="insert")
        m.histogram("lat", buckets=(10, 100)).observe(42)
        for i in range(6):
            m.record_wave({"i": i})
        assert [r["i"] for r in m.ring.records()] == [2, 3, 4, 5]
        path = tmp_path / f"{name}.jsonl"
        m.to_jsonl(str(path))
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        for ln in lines:
            ln.pop("ts", None)
        assert any(ln.get("metric") == "filter_waves" for ln in lines)
        assert sum(1 for ln in lines if ln["type"] == "wave") == 4
        text = m.prometheus_text()
        assert 'filter_waves_total{kind="insert"} 3.0' in text
        assert 'lat_bucket{le="+Inf"} 1.0' in text
        assert "# TYPE lat histogram" in text
        out[name] = (lines, text)
    assert out["port"] == out["ref"]


def test_trace_recorder_perfetto_shape(tmp_path):
    docs = {}
    for name, tracer in (("port", TraceRecorder), ("ref", RefTracer)):
        t = [0.0]

        def clock():
            t[0] += 0.001
            return t[0]

        tr = tracer(process_name="test", clock=clock)
        with tr.span("outer", kind="insert"):
            with tr.span("inner"):
                pass
        tr.instant("mark")
        tr.counter("fill", table=0.5)
        path = tmp_path / f"{name}.json"
        tr.save(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        names = [e["name"] for e in events]
        assert "outer" in names and "inner" in names and "mark" in names
        assert all(e["dur"] > 0 for e in events if e.get("ph") == "X")
        inner = next(e for e in events if e["name"] == "inner")
        outer = next(e for e in events if e["name"] == "outer")
        assert outer["ts"] <= inner["ts"]
        assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
        assert outer["args"]["kind"] == "insert"
        for e in events:
            e.pop("pid", None)
            e.pop("tid", None)
        docs[name] = events
    assert docs["port"] == docs["ref"]


def test_trace_recorder_annotates_torch_profiler():
    from torch.profiler import ProfilerActivity, profile
    tr = TraceRecorder(torch_profiler=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("ring_lookup"):
            pass
    assert any(ev.key == "ring_lookup" for ev in prof.key_averages())
    assert [e["name"] for e in tr.events if e.get("ph") == "X"] == [
        "ring_lookup"]


def test_recovery_metrics_match_reference():
    port, ref = MetricsRegistry(), RefRegistry()
    for rec in (RecoveryMetrics(metrics=port), RefRecovery(metrics=ref)):
        rec.fault("kill", 2)
        rec.degraded(5)
        rec.migration("split", keys=100, rounds=3, failed=1, seconds=0.5)
        rec.recovered("kill", 1.25)
        rec.backlog(7)
        rec.drained(4)
    assert port.snapshot() == ref.snapshot()


def test_admission_controller_transition_counters():
    class Fills:
        def __init__(self):
            self.v = (0.0, 0.0)

        def fills(self):
            return self.v

    snaps = []
    for ctl_cls, cfg_cls, registry in (
            (AdmissionController, AdmissionConfig, MetricsRegistry),
            (RefAdmissionController, RefAdmissionConfig, RefRegistry)):
        m, f = registry(), Fills()
        ctl = ctl_cls(filt=f, config=cfg_cls(high_water=0.5, low_water=0.2),
                      metrics=m)
        assert ctl.peek()
        f.v = (1.0, 1.0)
        assert not ctl.peek()          # trip
        assert not ctl.peek()          # still tripped: no double count
        f.v = (0.0, 0.0)
        assert ctl.peek()              # readmit
        assert m.counter("admission_trips").value() == 1
        assert m.counter("admission_readmits").value() == 1
        assert m.gauge("admission_peak_signal").value() == 1.0
        snaps.append(m.snapshot())
    assert snaps[0] == snaps[1]
