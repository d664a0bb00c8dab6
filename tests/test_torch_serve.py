"""The port's serving driver and backpressure policy against the
reference's: ``repro_torch.launch.serve.serve(..., smoke=True,
device="cpu")`` and ``repro.launch.serve.serve`` with the same seed see the
same request stream, so their prefix-cache indexes give identical hit
rates, reused blocks, index and OCF statistics and request counters (the
weights differ: each package initialises its own from the seed, so tokens
are not compared here; ``test_torch_decode.py`` holds them on shared
weights).  The ``BackpressureController`` cases mirror
``tests/test_obs.py``."""
import dataclasses

import numpy as np
import pytest

from repro.core import filter as jfilter
from repro.core.filter_ops import FilterOps
from repro.kernels import ops as kops
from repro.launch.serve import serve as ref_serve
from repro.obs import MetricsRegistry as RefRegistry
from repro.serving.engine import BackpressureController as RefController
from repro.serving.scheduler import FilterOpBatcher
from repro.streaming.admission import AdmissionConfig
from repro_torch.core.filter import make_state
from repro_torch.core.filter_ops import FilterOps as PortOps
from repro_torch.kernels import cuda
from repro_torch.kernels.stash import make_stash
from repro_torch.launch.serve import serve
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.serving import BackpressureConfig, BackpressureController
from repro_torch.serving import FilterOpBatcher as PortBatcher
from repro_torch.streaming.admission import AdmissionConfig as PortAdmission

pytestmark = pytest.mark.tier1

KW = dict(requests=6, prefix_len=48, gen=4, block=16, seed=3)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mistral-nemo-12b",
                                  "deepseek-v2-lite-16b", "mamba2-1.3b",
                                  "recurrentgemma-2b"])
def test_serve_matches_reference_index(arch):
    ref_m, port_m = RefRegistry(), MetricsRegistry()
    want = ref_serve(arch, smoke=True, metrics=ref_m, **KW)
    cuda.reset_counts()
    tracer = TraceRecorder(process_name="serve")
    got = serve(arch, smoke=True, device="cpu", metrics=port_m,
                tracer=tracer, **KW)
    assert got["prefix_hit_rate"] == want["prefix_hit_rate"]
    assert got["reused_blocks"] == want["reused_blocks"] > 0
    assert dataclasses.asdict(got["index_stats"]) == dataclasses.asdict(
        want["index_stats"])
    assert dataclasses.asdict(got["ocf_stats"]) == dataclasses.asdict(
        want["ocf_stats"])
    assert got["filter_occupancy"] == want["filter_occupancy"]
    for name in ("serve_requests", "serve_prefix_blocks_reused",
                 "serve_tokens_generated"):
        assert port_m.counter(name).value() == ref_m.counter(name).value()
    assert got["health"]["requests_served"] == KW["requests"]
    assert got["latency_p99_s"] >= got["latency_mean_s"] > 0
    assert got["decode_tokens_per_s"] > 0
    # a prefill and a decode span per request
    names = [e["name"] for e in tracer.events if e.get("ph") == "X"]
    assert names.count("prefill") == names.count("decode") == KW["requests"]
    # serving runs the cached path: blockwise attention, no flash call
    assert cuda.PLAIN_CALLS["flash_attention"] == 0
    assert cuda.PLAIN_CALLS["probe"] > 0 and cuda.PLAIN_CALLS[
        "insert_bulk"] > 0


@pytest.mark.parametrize("registry,controller",
                         [(MetricsRegistry, BackpressureController),
                          (RefRegistry, RefController)])
def test_backpressure_trip_shed_readmit_sequence(registry, controller):
    """The admit -> defer -> shed -> admit walk over registry metrics
    (tests/test_obs.py::test_backpressure_trip_shed_readmit_sequence)."""
    m = registry()
    cfg = BackpressureConfig(defer_signal=0.8, resume_signal=0.5)
    bp = controller(m, cfg)
    sig = m.gauge("admission_signal")
    sig.set(0.1)
    assert bp.decide() == "admit"
    sig.set(0.9)
    m.counter("admission_trips").inc()
    m.counter("filter_deferred_waves").inc()
    assert bp.decide() == "defer"
    sig.set(0.7)
    assert bp.decide() == "defer"
    m.counter("filter_shed_ops").inc(128)
    assert bp.decide() == "shed"
    sig.set(0.4)
    m.counter("admission_readmits").inc()
    assert bp.decide() == "admit"
    snap = m.snapshot()
    assert snap['backpressure_decisions{decision="shed"}'] == 1
    assert snap['backpressure_decisions{decision="admit"}'] == 2


def _port_batcher(m):
    return PortBatcher(
        PortOps(evict_rounds=16),
        make_state(64, buffer_buckets=64, device="cpu"),
        stash=make_stash(8, device="cpu"), wave_slots=64, double_buffer=True,
        metrics=m,
        admission=PortAdmission(high_water=0.3, low_water=0.1))


def _ref_batcher(m):
    return FilterOpBatcher(
        FilterOps(backend="pallas", evict_rounds=16),
        jfilter.make_state(64, buffer_buckets=64), stash=kops.make_stash(8),
        wave_slots=64, double_buffer=True, metrics=m,
        admission=AdmissionConfig(high_water=0.3, low_water=0.1))


def test_backpressure_from_live_admission_metrics():
    """A burst through the port's admission-gated batcher (over the port's
    state) publishes trips, deferred waves and shed ops into the port's
    registry, and the port's controller reading it sheds, as the
    reference's batcher and controller do over the reference's registry
    (tests/test_obs.py::test_backpressure_from_live_admission_metrics)."""
    decisions = []
    for registry, controller, make in (
            (MetricsRegistry, BackpressureController, _port_batcher),
            (RefRegistry, RefController, _ref_batcher)):
        m = registry()
        batcher = make(m)
        bp = controller(m)
        trail = [bp.decide()]
        rng = np.random.RandomState(2)
        for _ in range(12):
            batcher.submit("insert", rng.randint(
                1, 2 ** 62, size=64, dtype=np.int64).astype(np.uint64))
        batcher.drain()
        snap = m.snapshot()
        assert snap.get("filter_deferred_waves", 0) >= 1
        assert snap.get("filter_shed_ops", 0) >= 1
        trail.append(bp.decide())
        decisions.append((trail, snap))
    (port_trail, port_snap), (ref_trail, ref_snap) = decisions
    assert port_trail == ref_trail == ["admit", "shed"]

    def counts(snap):  # the wave latencies are host times
        return {k: v for k, v in snap.items() if "latency" not in k}
    assert counts(port_snap) == counts(ref_snap)
