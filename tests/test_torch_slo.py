"""The port's SLO harness and scenario workloads
(``repro_torch.serving.slo``, ``repro_torch.serving.workloads``) on the CPU,
held against the reference's (``repro.serving.slo`` with
``backend="pallas"``, the emulation arm): byte-identical streams, equal
percentiles and rows, and per scenario equal wave results, final states and
report fields apart from host times.  The contracts of
``tests/test_slo.py`` (double-buffered path bit for bit, admission under a
burst, TTL churn) are held on the port."""
import numpy as np
import pytest

from repro.serving import slo as ref_slo
from repro.serving.workloads import scenario_stream as ref_stream
from repro.streaming.admission import AdmissionConfig as RefAdmission
from repro_torch.serving import slo
from repro_torch.serving.workloads import SCENARIOS, scenario_stream
from repro_torch.streaming.admission import AdmissionConfig

from torch_port_util import (SLO_SMALL, SLO_WS, assert_same_ring,
                             recording_harness, report_fields, u32)

pytestmark = [pytest.mark.tier1, pytest.mark.slo]

WS = SLO_WS
SMALL = SLO_SMALL

# Non-default knobs of every generator.
OTHER = {
    "uniform": dict(waves=5, write_frac=0.5),
    "zipfian": dict(waves=5, a=1.5, write_frac=0.4),
    "adversarial": dict(rounds=3, pool_waves=3),
    "burst_train": dict(bursts=3, burst_waves=3, gap_waves=1),
    "ttl_churn": dict(waves=7, dt=0.5, window=2),
    "delete_heavy": dict(waves=7),
}


# ------------------------------------------------------------- streams --


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_streams_match_reference(name):
    """Every scenario, two seeds, the short and other knobs: the port's
    stream is the reference's byte for byte."""
    for seed in (0, 123):
        for ws, kw in ((WS, SMALL[name]), (48, OTHER[name])):
            got = scenario_stream(name, seed, wave_slots=ws, **kw)
            want = ref_stream(name, seed, wave_slots=ws, **kw)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert (x.kind, x.burst, x.advance, x.feedback) == \
                       (y.kind, y.burst, y.advance, y.feedback)
                assert x.keys.dtype == y.keys.dtype == np.uint64
                assert x.keys.tobytes() == y.keys.tobytes()
                assert not (x.keys == 0).any()     # key 0 is padding


def test_default_streams_match_reference():
    """The generators' default lengths and wave size."""
    for name in SCENARIOS:
        got, want = scenario_stream(name, 0), ref_stream(name, 0)
        assert [(b.kind, b.keys.tobytes()) for b in got] == \
               [(b.kind, b.keys.tobytes()) for b in want]


def test_unknown_scenario_raises():
    with pytest.raises(KeyError):
        scenario_stream("nope", 0)


# ----------------------------------------------------- recorder, rows --


def _samples(rng, n=40):
    kinds = ("lookup", "insert", "delete", "report")
    return [(kinds[rng.randint(4)], float(rng.exponential(900.0)),
             int(rng.randint(1, 600)), bool(rng.randint(2)),
             bool(rng.rand() < 0.2)) for _ in range(n)]


def test_recorder_and_rows_match_reference():
    """On the same samples: op-weighted percentiles under every selector,
    op counts, kinds, and an ``SloReport``'s rows."""
    ref, port = ref_slo.LatencyRecorder(), slo.LatencyRecorder()
    for kind, us, ops, burst, deferred in _samples(np.random.RandomState(4)):
        for rec in (ref, port):
            rec.observe(kind, us, ops=ops, burst=burst, deferred=deferred)
    for sel in ({}, dict(kinds=("lookup",)), dict(burst=True),
                dict(burst=False, exclude_deferred=True),
                dict(kinds=("insert", "delete"), exclude_deferred=True),
                dict(kinds=("none",))):
        assert port.percentiles(**sel) == ref.percentiles(**sel), sel
        assert port.ops(**sel) == ref.ops(**sel)
    assert port.kinds() == ref.kinds()
    fields = dict(scenario="uniform", ops=port.ops(), waves=40, wall_s=0.25,
                  keys_per_s=port.ops() / 0.25,
                  percentiles_us=port.percentiles(), per_kind={},
                  extras={"reported_fps": 3, "peak_signal": 0.25})
    assert slo.SloReport(**fields).rows() == ref_slo.SloReport(**fields).rows()
    assert slo.SloReport(**fields).rows("x") == \
        ref_slo.SloReport(**fields).rows("x")


def test_recorder_percentiles_are_op_weighted():
    """tests/test_slo.py::test_recorder_percentiles_are_op_weighted."""
    rec = slo.LatencyRecorder()
    rec.observe("lookup", 100.0, ops=990)
    rec.observe("lookup", 1000.0, ops=10, deferred=True)
    p = rec.percentiles()
    assert p["p50"] == 100.0
    assert p["p999"] == 1000.0
    assert rec.percentiles(exclude_deferred=True)["p999"] == 100.0
    assert rec.ops() == 1000
    assert rec.percentiles(kinds=("insert",)) == {
        "p50": 0.0, "p99": 0.0, "p999": 0.0}


# --------------------------------------------- scenarios vs reference --


def _same_stack(port, ref):
    """Final state of two batchers, or of two rings."""
    if hasattr(ref, "gens"):
        assert_same_ring(ref, port)
        return
    np.testing.assert_array_equal(u32(port.state.table),
                                  np.asarray(ref.state.table))
    assert int(port.state.count) == int(ref.state.count)
    if ref.stash is not None:
        np.testing.assert_array_equal(u32(port.stash), np.asarray(ref.stash))
    if hasattr(ref.state, "sels"):
        for plane in ("sels", "khi", "klo"):
            np.testing.assert_array_equal(u32(getattr(port.state, plane)),
                                          np.asarray(getattr(ref.state,
                                                             plane)))
    assert port.fills() == ref.fills()


def _same_waves(port, ref):
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        if hasattr(r, "results"):
            assert p.kind == r.kind and p.n == r.n, i
            assert p.deferred_ticks == r.deferred_ticks, i
            p, r = p.results, r.results
        if r is None:
            assert p is None, i
        else:
            np.testing.assert_array_equal(p, np.asarray(r), err_msg=str(i))


# A smaller adaptive stack (load ~0.5 at fp_bits 8), so the short
# adversarial stream has false positives to report.
STACKS = {"adversarial": dict(n_buckets=128)}


def _both(name, **kw):
    """One scenario through the reference's ``run_scenario`` (emulation
    arm) and the port's on the CPU -> (port, ref) (harness, report)."""
    kw = dict(seed=7, wave_slots=WS, stream_kwargs=SMALL[name],
              stack_kwargs=STACKS.get(name), **kw)
    ph, rh = (recording_harness(slo.SloHarness),
              recording_harness(ref_slo.SloHarness))
    prep = slo.run_scenario(name, device="cpu", harness=ph, **kw)
    rrep = ref_slo.run_scenario(name, backend="pallas", harness=rh,
                                warmup=False, **kw)
    return (ph, prep), (rh, rrep)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_scenario_matches_reference(name):
    """Each wave's results, the final state (the ring's generations for
    ``ttl_churn``) and every report field that is no host time."""
    (ph, prep), (rh, rrep) = _both(name, double_buffer=True)
    _same_waves(ph.waves, rh.waves)
    _same_stack(ph.target, rh.target)
    assert report_fields(prep) == report_fields(rrep)
    assert prep.ops > 0 and prep.percentiles_us["p99"] > 0
    if name == "adversarial":
        assert prep.extras["reported_fps"] > 0


def test_admission_arm_matches_reference():
    """The burst train behind a hysteresis gate on a small stack: the same
    waves deferred, re-admitted and shed as the reference's, the same
    results and state."""
    stack = dict(n_buckets=128, stash_slots=8)
    kw = dict(seed=0, wave_slots=WS, double_buffer=True, stack_kwargs=stack,
              stream_kwargs=dict(bursts=3, burst_waves=4, gap_waves=3))
    ph, rh = (recording_harness(slo.SloHarness),
              recording_harness(ref_slo.SloHarness))
    prep = slo.run_scenario(
        "burst_train", device="cpu", harness=ph,
        admission=AdmissionConfig(high_water=0.18, low_water=0.12), **kw)
    rrep = ref_slo.run_scenario(
        "burst_train", backend="pallas", harness=rh, warmup=False,
        admission=RefAdmission(high_water=0.18, low_water=0.12), **kw)
    _same_waves(ph.waves, rh.waves)
    _same_stack(ph.target, rh.target)
    assert report_fields(prep) == report_fields(rrep)
    assert prep.deferred_waves > 0 and prep.shed_ops > 0


# ------------------------------------------------ contracts on the port --


def _replay(name, *, double_buffer, seed=7):
    """tests/test_slo.py::_replay on the port -> (batcher, results)."""
    batcher = slo.make_batcher(name, device="cpu",
                               double_buffer=double_buffer, wave_slots=WS)
    waves = []
    for batch in scenario_stream(name, seed, wave_slots=WS, **SMALL[name]):
        wave = batcher.submit(batch.kind, batch.keys)
        waves.append(wave)
        if batch.feedback:
            batcher.flush()
            hits = batch.keys[wave.results]
            if hits.size:
                waves.append(batcher.submit("report", hits))
    batcher.drain()
    return batcher, [w.results for w in waves]


@pytest.mark.parametrize("scenario", ["uniform", "burst_train",
                                      "delete_heavy", "adversarial"])
def test_double_buffered_path_is_bit_for_bit(scenario):
    """tests/test_slo.py::test_double_buffered_path_is_bit_for_bit: every
    wave's results and the final state equal on the two submit paths."""
    ba, ra = _replay(scenario, double_buffer=True)
    bs, rs = _replay(scenario, double_buffer=False)
    assert len(ra) == len(rs)
    for x, y in zip(ra, rs):
        np.testing.assert_array_equal(x, y)
    for plane in ("table", "sels", "khi", "klo"):
        if hasattr(ba.state, plane):
            assert (getattr(ba.state, plane) ==
                    getattr(bs.state, plane)).all()
    assert int(ba.state.count) == int(bs.state.count)
    if ba.stash is not None:
        assert (ba.stash == bs.stash).all()


def test_admission_defers_readmits_and_sheds_under_burst():
    """tests/test_slo.py::
    test_admission_defers_readmits_and_sheds_under_burst."""
    batcher = slo.make_batcher(
        "burst_train", device="cpu", wave_slots=WS, n_buckets=128,
        stash_slots=8, double_buffer=True,
        admission=AdmissionConfig(high_water=0.18, low_water=0.12))
    stream = scenario_stream("burst_train", 0, wave_slots=WS,
                             bursts=3, burst_waves=4, gap_waves=3)
    report = slo.SloHarness().run(batcher, stream,
                                  scenario="burst_admission")
    assert report.deferred_waves > 0
    assert [s for s in report.recorder.samples if s.deferred]
    assert batcher.admission.peak_signal >= 0.18
    assert report.extras["peak_signal"] >= 0.18
    admitted = report.recorder.percentiles(exclude_deferred=True)
    assert report.percentiles_us["p99"] >= admitted["p99"]
    lo, hi = batcher.fills()
    assert 0.0 <= lo <= 1.0 and 0.0 <= hi <= 1.0


def test_burst_waves_share_the_bursts_arrival():
    """Every wave of a run of burst batches is stamped with the run's
    arrival, so a wave later in the train carries its wait."""
    clock = iter(float(t) for t in range(10_000))
    h = slo.SloHarness(clock=lambda: next(clock))
    batcher = slo.make_batcher("burst_train", device="cpu", wave_slots=WS,
                               double_buffer=False)
    batcher._clock = h._clock
    stream = scenario_stream("burst_train", 3, wave_slots=WS,
                             bursts=1, burst_waves=3, gap_waves=1)
    report = h.run(batcher, stream, scenario="burst_train")
    burst = [s.us for s in report.recorder.samples if s.burst]
    assert len(burst) == 3
    assert burst[0] < burst[1] < burst[2]


def test_ttl_churn_expires_generations():
    """tests/test_slo.py::test_ttl_churn_expires_generations."""
    rep = slo.run_scenario("ttl_churn", seed=5, wave_slots=WS, warmup=False,
                           device="cpu", stream_kwargs=SMALL["ttl_churn"])
    assert rep.extras["expirations"] > 0
    assert rep.ops == WS * SMALL["ttl_churn"]["waves"]
    assert rep.percentiles_us["p99"] > 0


def test_report_rows_shape_and_monotonicity():
    """tests/test_slo.py::test_report_rows_shape_and_monotonicity."""
    rep = slo.run_scenario("uniform", seed=3, wave_slots=WS, device="cpu",
                           stream_kwargs=SMALL["uniform"])
    rows = rep.rows()
    for suffix in ("p50_us", "p99_us", "p999_us", "keys_per_s"):
        assert f"slo_uniform_{suffix}" in rows
    assert rows["slo_uniform_p50_us"] <= rows["slo_uniform_p99_us"] \
        <= rows["slo_uniform_p999_us"]
    assert rows["slo_uniform_keys_per_s"] > 0
    assert rep.ops == sum(s.ops for s in rep.recorder.samples)


def test_cuda_device_raises_without_a_card():
    """``device="cuda"`` never falls back to the plain versions."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        slo.make_batcher("uniform")
    with pytest.raises(RuntimeError):
        slo.run_scenario("ttl_churn", stream_kwargs=SMALL["ttl_churn"],
                         wave_slots=WS)


# ------------------------------------------------------------ telemetry --


def _read_metrics(path):
    """A metrics JSONL file -> ({series: value or bucket counts} without
    the host's latencies, [(kind, n, deferred_ticks) of each wave])."""
    import json
    series, waves = {}, []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["type"] == "wave":
                r = rec["record"]
                waves.append((r["kind"], r["n"], r["deferred_ticks"]))
            elif "latency" not in rec["metric"]:
                key = (rec["metric"], tuple(sorted(rec["labels"].items())))
                series[key] = rec.get("value", rec.get("counts"))
    return series, waves


def _probe_depth(series):
    return sum(v for (name, _), v in series.items()
               if name == "filter_probe_depth")


def _telemetry_pair(name, tmp_path):
    rep, paths = slo.run_scenario_telemetry(name, str(tmp_path / "port"),
                                            device="cpu", double_buffer=True)
    assert rep.extras["telemetry_files"] == paths
    for path in paths.values():
        assert (tmp_path / "port").joinpath(path.rsplit("/", 1)[-1]).stat(
        ).st_size > 0
    _rrep, rpaths = ref_slo.run_scenario_telemetry(
        name, str(tmp_path / "ref"), backend="pallas", double_buffer=True)
    return _read_metrics(paths["metrics"]), _read_metrics(rpaths["metrics"])


def test_run_scenario_telemetry_full_waves_match_reference(tmp_path):
    """Both files written; on adversarial's full lookup waves every counter
    and every wave record equals the reference's."""
    (port, pwaves), (ref, rwaves) = _telemetry_pair("adversarial", tmp_path)
    assert pwaves == rwaves
    assert port == ref
    assert _probe_depth(port) > 0
    assert port[("filter_selector_bumps", ())] > 0


def test_run_scenario_telemetry_padding_lanes(tmp_path):
    """On zipfian's deduped lookup waves the reference's probe-depth total
    exceeds the port's by exactly those waves' padding lanes (its batcher
    probes them; the port's probes the wave's own keys), and every other
    counter equals the reference's."""
    (port, pwaves), (ref, rwaves) = _telemetry_pair("zipfian", tmp_path)
    assert pwaves == rwaves
    lookups = [b.keys for b in scenario_stream("zipfian", 0)
               if b.kind == "lookup"]
    uniq = sum(np.unique(k).size for k in lookups)
    padding = 512 * len(lookups) - uniq
    assert padding > 0
    assert _probe_depth(port) == uniq
    assert _probe_depth(ref) - _probe_depth(port) == padding
    strip = {k: v for k, v in port.items() if k[0] != "filter_probe_depth"}
    assert strip == {k: v for k, v in ref.items()
                     if k[0] != "filter_probe_depth"}
