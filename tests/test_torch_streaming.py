"""The streaming slice: the port's ``GenerationalFilter`` on the CPU
against the reference's on its kernel backend (``backend="pallas"``, the
kernels' XLA grid emulation off-TPU), started from the same state through
``convert.generational_from_numpy``.  Per-generation tables and stashes,
counts, birth and expiry times, the ring's clock, ``GenStats`` and every
answer must match after every operation.  Mirrors the generation and
admission tests of ``tests/test_streaming.py``."""
import numpy as np
import pytest
import torch

from repro.core.policy import EofPolicy as RefEofPolicy
from repro.streaming import AdmissionConfig as RefAdmissionConfig
from repro.streaming import AdmissionController as RefAdmissionController
from repro.streaming import GenerationConfig as RefConfig
from repro.streaming import GenerationalFilter as RefRing
from repro.streaming.stash import make_sharded_stashes as ref_sharded
from repro.streaming.stash import sharded_stash_fill as ref_sharded_fill
from repro_torch.convert import generational_from_numpy
from repro_torch.core.policy import EofPolicy
from repro_torch.obs import MetricsRegistry
from repro_torch.streaming import (AdmissionConfig, AdmissionController,
                                   GenerationalFilter, GenerationConfig,
                                   OverflowStash, congestion_signal)
from repro_torch.streaming.stash import (make_sharded_stashes,
                                         sharded_stash_fill)

from torch_port_util import assert_same_ring, random_keys, ref_ring_snapshot

pytestmark = pytest.mark.tier1


class Rings:
    """A reference ring and a port ring from the same state; every call
    goes to both, and answers and state are compared after it."""

    def __init__(self, now=0.0, ref=None, **kw):
        self.ref = ref or RefRing(RefConfig(backend="pallas", **kw), now=now)
        self.port = generational_from_numpy(
            GenerationConfig(device="cpu", **kw),
            **ref_ring_snapshot(self.ref))
        self.steps = 0
        self.check("start")

    def check(self, where):
        assert_same_ring(self.ref, self.port, where)

    def __getattr__(self, op):
        def call(*args, **kw):
            a = getattr(self.ref, op)(*args, **kw)
            b = getattr(self.port, op)(*args, **kw)
            self.steps += 1
            where = f"step {self.steps} ({op})"
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=where)
            else:
                assert a == b, (where, a, b)
            self.check(where)
            return b
        return call


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_generation_rotation_keeps_last_k_visible(rng):
    r = Rings(generations=3, capacity=2048, stash_slots=32, ttl=None)
    batches = [random_keys(rng, 700) for _ in range(4)]
    for i, b in enumerate(batches):
        assert r.insert(b, now=float(i)).all()
        assert r.lookup(np.concatenate(batches), now=float(i))[
            max(0, i - 2) * 700:(i + 1) * 700].all()
        if i < len(batches) - 1:
            r.rotate(now=float(i))
    assert r.port.stats.rotations == 3
    assert r.port.live_generations == r.ref.live_generations == 3
    for b in batches[-3:]:
        assert r.lookup(b, now=10.0).all()
    assert not r.lookup(batches[0], now=10.0).all()


def test_generation_ttl_lazy_expiry_and_pool_reuse(rng):
    r = Rings(generations=2, capacity=1024, stash_slots=32, ttl=10.0)
    pool = r.port.pool
    ptrs = (pool.tables.data_ptr(), pool.stashes.data_ptr())
    keys = random_keys(rng, 600)
    assert r.insert(keys, now=0.0).all()
    assert r.lookup(keys, now=9.9).all()
    # lazy: no advance() call, yet an expired generation answers nothing
    assert not r.lookup(keys, now=10.1).any()
    assert r.port.stats.expirations == 0
    assert r.advance(now=10.1) == 1
    assert r.port.stats.expirations == 1
    k2 = random_keys(rng, 600)
    assert r.insert(k2, now=11.0).all()
    assert r.lookup(k2, now=12.0).all()
    # the ring never allocated a table or a stash: every generation works
    # on its slot of the same two pool tensors throughout
    assert (pool.tables.data_ptr(), pool.stashes.data_ptr()) == ptrs
    assert sorted([g.slot for g in r.port.gens] + pool._free) == [0, 1]
    for g in r.port.gens:
        assert g.state.table.data_ptr() == pool.tables[g.slot].data_ptr()
        assert g.stash.array.data_ptr() == pool.stashes[g.slot].data_ptr()


def test_generation_insert_failure_rotates_and_retries(rng):
    r = Rings(generations=2, capacity=256, stash_slots=16, evict_rounds=4,
              o_max=2.0, stash_high=2.0)   # no proactive rotation
    keys = random_keys(rng, 400)           # > capacity + stash
    ok = r.insert(keys, now=0.0)
    assert r.port.stats.rotate_retries > 0 and r.port.stats.rotations >= 1
    assert r.port.stats.spills > 0
    assert ok.all(), "retry in the fresh generation must land the residue"
    assert r.lookup(keys, now=0.0).all()


def test_warm_state_converts_and_continues(rng):
    """A reference ring driven through rotations, spills and a TTL expiry,
    then converted mid-stream: both continue identically, with lookup
    dedup on."""
    kw = dict(generations=3, capacity=1024, stash_slots=16, evict_rounds=4,
              ttl=5.0, dedupe_lookups=True)
    ref = RefRing(RefConfig(backend="pallas", **kw), now=0.0)
    for t in range(4):
        ref.insert(random_keys(rng, 900), now=float(t))
    assert ref.stats.rotations >= 2 and ref.stats.spills > 0
    r = Rings(ref=ref, **kw)
    keys = random_keys(rng, 500)
    for t in (4.0, 5.5, 7.0):
        r.insert(keys, now=t)
        r.lookup(np.concatenate([keys, keys[:100], random_keys(rng, 300)]),
                 now=t)
    r.advance(now=12.0)
    assert r.port.stats.expirations >= 1


def test_lookups_never_answer_from_a_stale_stack(rng):
    """Inserts update the pool in place between lookups, and lookups
    alternate between all live generations and the active one: every
    answer must still be the reference's (a fan-out input cached by the
    tensors' identity would answer from the old contents)."""
    r = Rings(generations=3, capacity=2048, stash_slots=16, ttl=None)
    a, b, c = (random_keys(rng, 300) for _ in range(3))
    probe = np.concatenate([a, b, c])
    r.insert(a, now=0.0)
    assert r.lookup(probe, now=0.0)[:300].all()
    r.insert(b, now=0.0)                     # same generation, in place
    assert r.lookup(probe, now=0.0)[:600].all()
    r.rotate(now=1.0)
    present = np.zeros(probe.size, bool)
    present[:600] = True
    for i, off in enumerate((600, 0, 300)):  # lookup / lookup_active / insert
        hot = r.lookup(probe, now=1.0 + i)
        active = r.lookup_active(probe, now=1.0 + i)
        assert hot[present].all()
        r.insert(probe[off:off + 200], now=1.0 + i)
        present[off:off + 200] = True
        assert r.lookup_active(probe[off:off + 200], now=1.0 + i).all()
        assert r.lookup(probe, now=1.0 + i)[present].all()
    assert active.sum() < hot.sum()


def test_admission_controller_hysteresis(rng):
    kw = dict(generations=2, capacity=512, stash_slots=64, evict_rounds=4,
              o_max=0.97, stash_high=2.0)
    r = Rings(**kw)
    ref_ctl = RefAdmissionController(r.ref, RefAdmissionConfig(
        high_water=0.35, low_water=0.1))
    ctl = AdmissionController(r.port, AdmissionConfig(high_water=0.35,
                                                      low_water=0.1))
    assert ctl.admit() and ref_ctl.admit(), "idle filter admits"
    r.insert(random_keys(rng, 480), now=0.0)
    assert ctl.signal() == ref_ctl.signal() >= 0.35
    assert r.port.fills() == r.ref.fills()
    assert not ctl.admit() and not ref_ctl.admit()
    assert ctl.deferred == ref_ctl.deferred == 1
    r.rotate(now=1.0)
    assert ctl.signal() == ref_ctl.signal() <= 0.1
    assert ctl.admit() and ref_ctl.admit(), "hysteresis resets"
    a = AdmissionConfig(stash_weight=0.5, fill_weight=0.5)
    assert congestion_signal(0.4, 0.8, a) == pytest.approx(0.6)


def test_admission_observe_eof_accelerates_window():
    def drive(signal_value, ctl_cls, ring, policy):
        ctl = ctl_cls(ring)
        ctl.signal = lambda: signal_value
        pol = policy(c_min=64)
        pol.observe(items=90, capacity=100, ops=1)
        calls = 0
        while calls < 1000:
            calls += 1
            if ctl.observe_eof(pol, items=90, capacity=100, ops=7):
                break
        return pol.t_cur

    port = GenerationalFilter(GenerationConfig(generations=2, capacity=512,
                                               device="cpu"), now=0.0)
    ref = RefRing(RefConfig(generations=2, capacity=512, backend="pallas"),
                  now=0.0)
    got = [drive(s, AdmissionController, port, EofPolicy) for s in (1.0, 0.0)]
    want = [drive(s, RefAdmissionController, ref, RefEofPolicy)
            for s in (1.0, 0.0)]
    assert got == want and got[0] > got[1]


def test_rotation_and_expiry_counters():
    m = MetricsRegistry()
    gf = GenerationalFilter(GenerationConfig(generations=2, capacity=512,
                                             ttl=3.0, device="cpu"),
                            now=0.0, metrics=m)
    gf.rotate(now=1.0)
    gf.rotate(now=2.0)
    assert gf.advance(now=5.5) == 2
    assert m.counter("generation_rotations").value() == 2
    assert m.counter("generation_expirations").value() == 2
    assert gf.live_generations == 1


def test_empty_batches_streaming():
    r = Rings(generations=2, capacity=512)
    empty = np.zeros((0,), np.uint64)
    assert r.insert(empty, now=0.0).shape == (0,)
    assert r.lookup(empty, now=0.0).shape == (0,)
    assert r.lookup_active(empty, now=0.0).shape == (0,)
    assert len(r.port) == 0


def test_config_errors_and_stash_helpers():
    for bad in (dict(stash_slots=0), dict(generations=0)):
        with pytest.raises(ValueError):
            GenerationConfig(device="cpu", **bad)
        with pytest.raises(ValueError):
            RefConfig(**bad)
    with pytest.raises(ValueError):
        GenerationalFilter(GenerationConfig(backend="pallas", device="cpu"))
    assert GenerationConfig(o_max=0.9).make_filter_ops().evict_rounds == 64
    st = OverflowStash(8, device="cpu")
    assert st.array.shape == (2, 8) and st.fill == 0.0
    st.array[0, :2] = 7
    assert st.occupancy == 2 and st.fill == 0.25
    stacks = make_sharded_stashes(3, 4, device="cpu")
    stacks[1, 0, :3] = 5
    want = np.asarray(ref_sharded_fill(ref_sharded(3, 4).at[1, 0, :3].set(5)))
    np.testing.assert_array_equal(sharded_stash_fill(stacks).numpy(), want)
    assert sharded_stash_fill(stacks).dtype == torch.float32
