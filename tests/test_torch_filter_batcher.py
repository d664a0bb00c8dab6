"""The port's ``FilterOpBatcher`` (``repro_torch.serving.scheduler``) on the
CPU: the contracts of the reference's batcher tests (``tests/test_obs.py``
and ``tests/test_slo.py``) held on the port, and the reference's batcher
and the port's on one seeded wave stream with telemetry on: equal wave
results, tables, stashes and counts, and equal registry snapshots apart
from the latencies (host times)."""
import numpy as np
import pytest
import torch

import repro_torch.kernels.ops as kops_mod
from repro.adaptive.state import make_adaptive_state as ref_adaptive_state
from repro.core import filter as jfilter
from repro.core.filter_ops import FilterOps as RefOps
from repro.kernels import ops as ref_kops
from repro.obs import MetricsRegistry as RefRegistry
from repro.serving.scheduler import FilterOpBatcher as RefBatcher
from repro.streaming.oracle import PyAdaptiveFilter, PyStashFilter
from repro_torch.adaptive.state import make_adaptive_state
from repro_torch.core.filter import FilterState, make_state
from repro_torch.core.filter_ops import FilterOps
from repro_torch.kernels import cuda
from repro_torch.kernels.stash import make_stash
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.serving import scheduler as sched
from repro_torch.serving.scheduler import FilterOpBatcher
from repro_torch.streaming.admission import AdmissionConfig

from torch_port_util import u32

pytestmark = pytest.mark.tier1

WS = 64

# every kernels/ops.py entry point the batcher can reach, off and on
_SPIED = ("probe_dispatch", "filter_insert", "filter_delete",
          "adaptive_lookup", "adaptive_insert", "adaptive_delete",
          "adaptive_report", "probe_dispatch_tm", "filter_insert_tm",
          "filter_delete_tm", "adaptive_lookup_tm", "adaptive_insert_tm",
          "adaptive_delete_tm", "adaptive_report_tm")


def _spy_kops(monkeypatch):
    """Record the name of every ``kernels.ops`` entry point dispatched."""
    calls = []

    def wrap(name):
        orig = getattr(kops_mod, name)

        def wrapped(*a, **k):
            calls.append(name)
            return orig(*a, **k)
        return wrapped

    for name in _SPIED:
        monkeypatch.setattr(kops_mod, name, wrap(name))
    return calls


def _mk_batcher(**obs_kwargs):
    return FilterOpBatcher(FilterOps(evict_rounds=16),
                           make_state(256, buffer_buckets=256, device="cpu"),
                           stash=make_stash(16, device="cpu"), wave_slots=WS,
                           double_buffer=True, **obs_kwargs)


def _replay(batcher, rng):
    waves = []
    for i in range(6):
        kind = ("insert", "lookup", "delete")[i % 3]
        keys = rng.randint(1, 2 ** 62, size=WS, dtype=np.int64)
        waves.append(batcher.submit(kind, keys.astype(np.uint64)))
    batcher.flush()
    return [w.results for w in waves]


def _same_state(a, b):
    assert torch.equal(a.state.table, b.state.table)
    assert int(a.state.count) == int(b.state.count)
    if a.stash is not None:
        assert torch.equal(a.stash, b.stash)
    if hasattr(a.state, "sels"):
        for plane in ("sels", "khi", "klo"):
            assert torch.equal(getattr(a.state, plane),
                               getattr(b.state, plane))


def test_telemetry_off_dispatch_identical(monkeypatch):
    """tests/test_obs.py::test_telemetry_off_dispatch_identical: a
    registry and a tracer with telemetry OFF change neither the entry
    points dispatched nor any bit of the results and state, and no
    telemetry instantiation is launched."""
    calls = _spy_kops(monkeypatch)
    plain = _mk_batcher()
    res_plain = _replay(plain, np.random.RandomState(3))
    seq_plain = list(calls)
    calls.clear()
    cuda.reset_counts()
    observed = _mk_batcher(metrics=MetricsRegistry(),
                           tracer=TraceRecorder())
    res_obs = _replay(observed, np.random.RandomState(3))
    assert list(calls) == seq_plain
    assert not any(name.endswith("_tm") for name in calls)
    assert not any(name in cuda.TM_KERNELS for name in cuda.LAUNCHES)
    for a, b in zip(res_plain, res_obs):
        np.testing.assert_array_equal(a, b)
    _same_state(plain, observed)


def test_telemetry_on_counters_change_answers_dont(monkeypatch):
    """tests/test_obs.py::test_telemetry_on_counters_change_answers_dont."""
    calls = _spy_kops(monkeypatch)
    plain = _mk_batcher()
    res_plain = _replay(plain, np.random.RandomState(5))
    calls.clear()
    m = MetricsRegistry()
    on = _mk_batcher(telemetry=True, metrics=m)
    res_on = _replay(on, np.random.RandomState(5))
    assert calls and all(n.endswith("_tm") for n in calls)
    for a, b in zip(res_plain, res_on):
        np.testing.assert_array_equal(a, b)
    _same_state(plain, on)
    snap = m.snapshot()
    assert sum(snap["filter_kick_depth"]["counts"]) == 2 * WS
    assert 'filter_waves{kind="insert"}' in snap
    assert any(k.startswith("filter_probe_depth") for k in snap)
    assert "filter_stash_fill_hw" in snap
    assert len(m.ring) == 6


def test_adaptive_telemetry_parity():
    """tests/test_obs.py::test_adaptive_telemetry_parity."""
    def mk(**kw):
        return FilterOpBatcher(FilterOps(evict_rounds=16),
                               make_adaptive_state(256, device="cpu"),
                               stash=make_stash(8, device="cpu"),
                               wave_slots=WS, double_buffer=True, **kw)

    rng = np.random.RandomState(11)
    keys = rng.randint(1, 2 ** 62, size=WS, dtype=np.int64).astype(np.uint64)
    m = MetricsRegistry()
    on, off = mk(telemetry=True, metrics=m), mk()
    for b in (on, off):
        b.submit("insert", keys)
        b.submit("lookup", keys)
        b.submit("report", keys[:16])
        b.submit("delete", keys[:32])
        b.flush()
    _same_state(on, off)
    snap = m.snapshot()
    depth = sum(v for k, v in snap.items()
                if k.startswith("filter_probe_depth"))
    assert depth == WS
    assert snap.get("filter_table_deletes", 0) + snap.get(
        "filter_stash_deletes", 0) >= 1


def _ops_stream(rng, n_ops, pool):
    """tests/test_slo.py::_ops_stream: a single-key op mix over a pool."""
    ops, inserted = [], []
    for _ in range(n_ops):
        r = rng.random()
        key = int(pool[rng.integers(pool.size)])
        if r < 0.5 or not inserted:
            ops.append(("insert", key))
            inserted.append(key)
        elif r < 0.7:
            ops.append(("delete", inserted.pop(
                int(rng.integers(len(inserted))))))
        else:
            ops.append(("lookup", key))
    return ops


@pytest.mark.parametrize("telemetry", [False, True])
def test_single_lane_parity_vs_stash_oracle(telemetry):
    """tests/test_slo.py::test_single_lane_parity_vs_stash_oracle, with
    telemetry off and on."""
    NB, BS, FPB, ER, SS = 16, 4, 12, 8, 8
    rng = np.random.default_rng(11)
    pool = rng.integers(1, 2**63, 160, dtype=np.uint64)
    oracle = PyStashFilter(n_buckets=NB, bucket_size=BS, fp_bits=FPB,
                           evict_rounds=ER, stash_slots=SS)
    batcher = FilterOpBatcher(
        FilterOps(fp_bits=FPB, evict_rounds=ER),
        make_state(NB, BS, device="cpu"),
        stash=make_stash(SS, device="cpu"), wave_slots=1,
        double_buffer=True, telemetry=telemetry)
    for kind, key in _ops_stream(rng, 120, pool):
        wave = batcher.submit(kind, np.asarray([key], np.uint64))
        expect = getattr(oracle, kind)(key)
        batcher.flush()
        assert bool(wave.results[0]) == expect, (kind, key)
    np.testing.assert_array_equal(u32(batcher.state.table), oracle.table)
    np.testing.assert_array_equal(u32(batcher.stash), oracle.stash_array())
    assert int(batcher.state.count) == oracle.count


@pytest.mark.parametrize("telemetry", [False, True])
def test_single_lane_parity_vs_adaptive_oracle(telemetry):
    """tests/test_slo.py::test_single_lane_parity_vs_adaptive_oracle."""
    NB, BS, FPB, ER, SS = 32, 4, 8, 8, 8
    rng = np.random.default_rng(13)
    members = rng.integers(1, 2**63, 96, dtype=np.uint64)
    probes = rng.integers(1, 2**63, 64, dtype=np.uint64)
    oracle = PyAdaptiveFilter(n_buckets=NB, bucket_size=BS, fp_bits=FPB,
                              evict_rounds=ER, stash_slots=SS)
    batcher = FilterOpBatcher(
        FilterOps(fp_bits=FPB, evict_rounds=ER),
        make_adaptive_state(NB, BS, device="cpu"),
        stash=make_stash(SS, device="cpu"), wave_slots=1,
        double_buffer=True, telemetry=telemetry)

    def step(kind, key):
        wave = batcher.submit(kind, np.asarray([key], np.uint64))
        if kind == "report":
            expect = oracle.report_false_positive(int(key))[0]
        else:
            expect = getattr(oracle, kind)(int(key))
        batcher.flush()
        assert bool(wave.results[0]) == expect, (kind, key)

    for key in members:
        step("insert", key)
    for key in probes:
        wave = batcher.submit("lookup", np.asarray([key], np.uint64))
        batcher.flush()
        assert bool(wave.results[0]) == oracle.lookup(int(key))
        if wave.results[0]:
            step("report", key)
    for key in members[::3]:
        step("delete", key)
    st = batcher.state
    np.testing.assert_array_equal(u32(st.table), oracle.table)
    np.testing.assert_array_equal(u32(st.sels), oracle.sel_plane_array())
    khi, klo = oracle.key_planes()
    np.testing.assert_array_equal(u32(st.khi), khi)
    np.testing.assert_array_equal(u32(st.klo), klo)


def test_lookups_and_deletes_bypass_admission():
    """tests/test_slo.py::test_lookups_and_deletes_bypass_admission."""
    batcher = FilterOpBatcher(
        FilterOps(fp_bits=12, evict_rounds=8), make_state(16, 4,
                                                          device="cpu"),
        stash=make_stash(8, device="cpu"), wave_slots=WS,
        double_buffer=True,
        admission=AdmissionConfig(high_water=0.0, low_water=-1.0))
    keys = np.arange(1, WS + 1, dtype=np.uint64)
    w_ins = batcher.submit("insert", keys)
    w_look = batcher.submit("lookup", keys)
    w_del = batcher.submit("delete", keys)
    batcher.drain()
    assert w_ins.results is None               # parked forever (shed)
    assert w_look.results is not None and not w_look.results.any()
    assert w_del.results is not None
    assert batcher.stats.shed_ops == WS


class _CardTable:
    """Stands in for a table on the card (no card here)."""
    device = torch.device("cuda")
    shape = (16, 4)


def test_double_buffer_auto_resolves_per_device(monkeypatch):
    """tests/test_slo.py::test_double_buffer_auto_resolves_per_host, with
    the state's device in place of the JAX backend: a CUDA device always
    double-buffers, a CPU only with more than one core; explicit flags are
    never overridden."""
    def mk(state=None, **kw):
        return FilterOpBatcher(FilterOps(fp_bits=12),
                               state or make_state(16, 4, device="cpu"),
                               wave_slots=4, **kw)

    monkeypatch.setattr(sched.os, "cpu_count", lambda: 8)
    assert mk().double_buffer
    monkeypatch.setattr(sched.os, "cpu_count", lambda: 1)
    assert not mk().double_buffer
    assert mk(double_buffer=True).double_buffer
    # a state on the card: the batcher reads only its table's device and
    # shape before the first wave
    card = FilterState(_CardTable(), torch.zeros((), dtype=torch.int64), 16)
    assert mk(card).double_buffer
    assert not mk(card, double_buffer=False).double_buffer


def _ref_and_port(adaptive, telemetry, metrics):
    """The reference's and the port's batcher over equal empty states."""
    kw = dict(wave_slots=WS, double_buffer=True, telemetry=telemetry)
    if adaptive:
        ref = RefBatcher(RefOps(fp_bits=7, backend="pallas",
                                evict_rounds=4),
                         ref_adaptive_state(64),
                         stash=ref_kops.make_stash(8), metrics=metrics[0],
                         **kw)
        port = FilterOpBatcher(FilterOps(fp_bits=7, evict_rounds=4),
                               make_adaptive_state(64, device="cpu"),
                               stash=make_stash(8, device="cpu"),
                               metrics=metrics[1], **kw)
    else:
        ref = RefBatcher(RefOps(fp_bits=12, backend="pallas",
                                evict_rounds=4),
                         jfilter.make_state(64, 4),
                         stash=ref_kops.make_stash(8), metrics=metrics[0],
                         **kw)
        port = FilterOpBatcher(FilterOps(fp_bits=12, evict_rounds=4),
                               make_state(64, 4, device="cpu"),
                               stash=make_stash(8, device="cpu"),
                               metrics=metrics[1], **kw)
    return ref, port


def _wave_stream(seed, adaptive):
    """Insert waves to load ~0.95 (kicks, spills, rollbacks), lookups with
    repeats (dedup), reports of false positives, deletes that resolve in
    the table and the stash."""
    rng = np.random.RandomState(seed)
    members = rng.randint(1, 2 ** 62, size=4 * WS, dtype=np.int64
                          ).astype(np.uint64)
    benign = rng.randint(1, 2 ** 62, size=WS, dtype=np.int64
                         ).astype(np.uint64)
    stream = [("insert", members[i:i + WS]) for i in range(0, 4 * WS, WS)]
    # 72 keys, 64 after dedup: a full wave (the reference's probe-depth
    # plane also counts a partial wave's padding lanes; the port's does not)
    stream.append(("lookup", np.concatenate([members[:40], members[:8],
                                             benign[:24]])))
    if adaptive:
        stream.append(("report", benign))
    stream.append(("lookup", benign))
    stream += [("delete", members[i:i + WS]) for i in range(0, 4 * WS, WS)]
    return stream


@pytest.mark.parametrize("adaptive", [False, True])
def test_batcher_matches_reference_batcher(adaptive):
    """One seeded wave stream through the reference's batcher and the
    port's, telemetry on: equal results and states, and equal registries
    apart from the latencies."""
    ref_m, port_m = RefRegistry(), MetricsRegistry()
    ref, port = _ref_and_port(adaptive, True, (ref_m, port_m))
    ref_waves, port_waves = [], []
    for kind, keys in _wave_stream(7, adaptive):
        if kind == "delete":
            # a raw state has no keystore: delete only what was taken
            present = ref_waves[0][1].results
            for w in ref_waves[1:4]:
                present = np.concatenate([present, w[1].results])
            taken = np.concatenate([k for k, _ in ref_waves[:4]])[present]
            keys = keys[np.isin(keys, taken)]
        rw, pw = ref.submit(kind, keys), port.submit(kind, keys)
        ref_waves.append((keys, rw))
        port_waves.append((keys, pw))
    ref.flush()
    port.flush()
    for (_k, rw), (_k2, pw) in zip(ref_waves, port_waves):
        assert rw.kind == pw.kind
        np.testing.assert_array_equal(pw.results, rw.results)
    np.testing.assert_array_equal(u32(port.state.table),
                                  np.asarray(ref.state.table))
    np.testing.assert_array_equal(u32(port.stash), np.asarray(ref.stash))
    assert int(port.state.count) == int(ref.state.count)
    if adaptive:
        np.testing.assert_array_equal(u32(port.state.sels),
                                      np.asarray(ref.state.sels))
    assert port.fills() == ref.fills()

    def counts(snap):   # the wave latencies are host times
        return {k: v for k, v in snap.items() if "latency" not in k}
    want, got = counts(ref_m.snapshot()), counts(port_m.snapshot())
    assert got == want
    for name in ("filter_stash_spills", "filter_rollback_lanes",
                 "filter_stash_deletes", "filter_table_deletes"):
        assert got.get(name, 0) > 0, name
    if adaptive:
        assert got.get("filter_selector_bumps", 0) > 0
    assert sum(got["filter_kick_depth"]["counts"][1:]) > 0


def test_lookup_depth_counts_only_the_waves_keys():
    """A partial lookup wave's probe-depth plane counts its keys alone, not
    the padding lanes (key 0, planted here so that it would hit)."""
    m = MetricsRegistry()
    b = FilterOpBatcher(FilterOps(fp_bits=12, evict_rounds=4),
                        make_state(64, 4, device="cpu"), wave_slots=8,
                        double_buffer=False, telemetry=True, metrics=m)
    b.submit("insert", np.array([0, 5, 6], np.uint64))
    wave = b.submit("lookup", np.array([5, 7], np.uint64))
    assert wave.results.tolist() == [True, False]
    snap = m.snapshot()
    depth = {k: v for k, v in snap.items()
             if k.startswith("filter_probe_depth")}
    assert sum(depth.values()) == 2
