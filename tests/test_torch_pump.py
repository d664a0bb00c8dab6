"""The deferred-write pump (``serving/scheduler.py``: ``DeferredWritePump``,
``PumpStats``, ``ShardedFilterFills``) against the reference's on
``filter_mesh(2)`` (reference in a subprocess with two CPU devices): the
skewed burst of ``tests/test_distributed_write.py``'s pump script under a
tight capacity, a gate held shut for three ticks, valid-mask padding that
must stay inert, and the real admission controller over a congested state.
Compared bit for bit: ``PumpStats``, the state, the hold and resume ticks
and the lookups; port ``"torch"`` against the reference's default
(``"auto"``, its scan arm on the CPU) and port ``"cuda"`` against
``"pallas"``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hashing as jhash
from repro_torch.core import distributed as dist
from repro_torch.core import hashing
from repro_torch.distributed.elastic import filter_mesh
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.serving.scheduler import (DeferredWritePump, PumpStats,
                                           ShardedFilterFills)

from torch_port_util import (LAYOUTS, REF_JIT_LOOKUP, layout_mesh,
                             reference_run, sharded_u32, split, t32)

pytestmark = pytest.mark.tier1

NB, BS, FP = 256, 4, 16
BACKENDS = {"torch": "auto", "cuda": "pallas"}

SCRIPT = REF_JIT_LOOKUP + """
import dataclasses
from repro.core import distributed as dist
from repro.distributed.elastic import filter_mesh
from repro.obs import MetricsRegistry, TraceRecorder
from repro.serving.scheduler import DeferredWritePump, ShardedFilterFills
mesh = filter_mesh(2)
hi, lo, shi, slo = (IN[k] for k in ("hi", "lo", "shi", "slo"))


class Gate:
    def __init__(self, closed):
        self.closed, self.tripped, self.log = closed, True, []

    def peek(self):
        self.closed -= 1
        self.tripped = self.closed >= 0
        self.log.append(not self.tripped)
        return not self.tripped


backend = str(IN["backend"])
# valid-mask semantics: poisoned invalid lanes must be inert
st = dist.make_sharded_state(2, 256, 4, stash_slots=64)
n = 64
vhi = jnp.concatenate([jnp.asarray(hi[:n]), jnp.zeros((n,), jnp.uint32)])
vlo = jnp.concatenate([jnp.asarray(lo[:n]), jnp.zeros((n,), jnp.uint32)])
valid = jnp.concatenate([jnp.ones((n,), bool), jnp.zeros((n,), bool)])
st, ok, dfr, _ = dist.distributed_insert(
    mesh, "data", st, vhi, vlo, fp_bits=16, valid=valid, backend=backend)
put(backend + "/mask", st, ok=ok, deferred=dfr)
zhit, _ = lookup(mesh, st, np.zeros(2, np.uint32), np.zeros(2, np.uint32),
                 fp_bits=16, backend=backend)
OUT[backend + "/zero_hit"] = zhit
# the skewed burst under a tight capacity, a gate shut for 3 ticks
reg, tr = MetricsRegistry(), TraceRecorder()
pump = DeferredWritePump(
    mesh, "data", dist.make_sharded_state(2, 256, 4, stash_slots=64),
    fp_bits=16, capacity_factor=0.25, backend=backend, metrics=reg,
    tracer=tr)
sok, sdfr = pump.submit(shi, slo)
OUT[backend + "/submit_ok"], OUT[backend + "/submit_deferred"] = sok, sdfr
OUT[backend + "/pending_after_submit"] = np.array(pump.pending)
gate = pump.admission = Gate(3)
pump.run_until_drained(max_ticks=64, on_held=lambda p: None)
OUT[backend + "/gate_log"] = np.array(gate.log)
OUT[backend + "/stats"] = np.array(
    list(dataclasses.asdict(pump.stats).values()))
OUT[backend + "/pending"] = np.array(pump.pending)
put(backend + "/pump", pump.state)
phits, _ = lookup(mesh, pump.state, shi, slo, fp_bits=16,
                  backend=backend)
OUT[backend + "/hits"] = phits
snap = reg.snapshot()
names = sorted(snap)
OUT[backend + "/metric_names"] = np.array(",".join(names))
OUT[backend + "/metric_values"] = np.array([snap[k] for k in names],
                                           float)
OUT[backend + "/spans"] = np.array(len(
    [e for e in tr.events if e["name"] == "pump_resubmit"]))
# the real admission controller over a congested state
full = dist.make_sharded_state(2, 64, 4, stash_slots=8)
pump = DeferredWritePump(mesh, "data", full, fp_bits=16,
                         capacity_factor=0.25, backend=backend)
pump.submit(hi[:480], lo[:480])
OUT[backend + "/congested_fills"] = np.array(
    ShardedFilterFills(lambda: pump.state).fills())
OUT[backend + "/congested_peek"] = np.array(pump.admission.peek())
pump.run_until_drained(max_ticks=8)
OUT[backend + "/congested_stats"] = np.array(
    list(dataclasses.asdict(pump.stats).values()))
OUT[backend + "/congested_pending"] = np.array(pump.pending)
put(backend + "/congested", pump.state)
"""


def _inputs():
    rng = np.random.RandomState(7)
    keys = np.unique(rng.randint(1, 2**63, size=1024, dtype=np.int64)
                     ).astype(np.uint64)
    hi, lo = split(keys)
    owner = jhash.owner_shard_np(hi, lo, 2)
    hot = keys[owner == 0]
    skew = np.concatenate([hot, hot, keys[owner == 1]])[:512]
    shi, slo = split(skew)
    return hi, lo, shi, slo


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs, one subprocess per backend (~30 s each: the
    pump's resubmissions have new shapes, each a new compile)."""
    runs = {}

    def get(backend):
        if backend not in runs:
            hi, lo, shi, slo = _inputs()
            runs[backend] = reference_run(
                SCRIPT, devices=2, inputs=dict(hi=hi, lo=lo, shi=shi,
                                               slo=slo,
                                               backend=np.array(backend)))
        return runs[backend]
    return get


class Gate:
    """Shut for ``closed`` peeks, then open (records each answer)."""

    def __init__(self, closed):
        self.closed, self.tripped, self.log = closed, True, []

    def peek(self):
        self.closed -= 1
        self.tripped = self.closed >= 0
        self.log.append(not self.tripped)
        return not self.tripped


def _same_state(ref, tag, state):
    tables, stashes = sharded_u32(state)
    np.testing.assert_array_equal(ref[tag + "/tables"], tables)
    np.testing.assert_array_equal(ref[tag + "/stashes"], stashes)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_valid_mask_lanes_stay_inert(ref, backend):
    tag = BACKENDS[backend]
    ref = ref(tag)
    hi, lo, _s, _t = _inputs()
    mesh = filter_mesh(2, device="cpu")
    st = dist.make_sharded_state(2, NB, BS, stash_slots=64, device="cpu")
    n = 64
    vhi = np.concatenate([hi[:n], np.zeros(n, np.uint32)])
    vlo = np.concatenate([lo[:n], np.zeros(n, np.uint32)])
    valid = np.arange(2 * n) < n
    st, ok, dfr, _ = dist.distributed_insert(
        mesh, "data", st, t32(vhi), t32(vlo), fp_bits=FP, backend=backend,
        valid=torch.from_numpy(valid))
    _same_state(ref, tag + "/mask", st)
    np.testing.assert_array_equal(ref[tag + "/mask/ok"], ok.numpy())
    np.testing.assert_array_equal(ref[tag + "/mask/deferred"], dfr.numpy())
    assert ok[:n].all() and not ok[n:].any() and not dfr.any()
    assert int((st.stacked()[0] != 0).sum()) == n
    zhit, _ = dist.distributed_lookup(mesh, "data", st,
                                      torch.zeros(2, dtype=torch.int32),
                                      torch.zeros(2, dtype=torch.int32),
                                      fp_bits=FP, backend=backend)
    assert not zhit.any() and not ref[tag + "/zero_hit"].any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_skewed_burst_pump_matches_reference(ref, backend, layout):
    tag = BACKENDS[backend]
    ref = ref(tag)
    _h, _l, shi, slo = _inputs()
    mesh = layout_mesh(2, layout)
    reg, tr = MetricsRegistry(), TraceRecorder()
    pump = DeferredWritePump(
        mesh, "data", dist.make_sharded_state(2, NB, BS, stash_slots=64,
                                              mesh=mesh),
        fp_bits=FP, capacity_factor=0.25, backend=backend, metrics=reg,
        tracer=tr)
    sok, sdfr = pump.submit(shi, slo)
    np.testing.assert_array_equal(ref[tag + "/submit_ok"], sok)
    np.testing.assert_array_equal(ref[tag + "/submit_deferred"], sdfr)
    assert sdfr.sum() > 0, "the tight capacity must defer"
    assert pump.pending == int(ref[tag + "/pending_after_submit"])
    gate = pump.admission = Gate(3)
    stats = pump.run_until_drained(max_ticks=64, on_held=lambda p: None)
    assert isinstance(stats, PumpStats)
    assert gate.log == ref[tag + "/gate_log"].tolist()
    assert list(dataclasses.asdict(pump.stats).values()) == \
        ref[tag + "/stats"].tolist()
    assert pump.stats.held_ticks == 3 and pump.pending == 0
    assert pump.stats.inserted == pump.stats.submitted
    _same_state(ref, tag + "/pump", pump.state)
    hits, _ = dist.distributed_lookup(mesh, "data", pump.state, t32(shi),
                                      t32(slo), fp_bits=FP, backend=backend)
    np.testing.assert_array_equal(ref[tag + "/hits"], hits.numpy())
    assert hits.all()
    snap = reg.snapshot()
    names = str(ref[tag + "/metric_names"]).split(",")
    assert sorted(snap) == names
    assert [snap[k] for k in names] == ref[tag + "/metric_values"].tolist()
    assert len([e for e in tr.events if e["name"] == "pump_resubmit"]) == \
        int(ref[tag + "/spans"]) > 0


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_admission_holds_a_congested_pump(ref, backend, layout):
    tag = BACKENDS[backend]
    ref = ref(tag)
    hi, lo, _s, _t = _inputs()
    mesh = layout_mesh(2, layout)
    pump = DeferredWritePump(
        mesh, "data", dist.make_sharded_state(2, 64, 4, stash_slots=8,
                                              mesh=mesh),
        fp_bits=FP, capacity_factor=0.25, backend=backend)
    pump.submit(hi[:480], lo[:480])
    fills = ShardedFilterFills(lambda: pump.state).fills()
    np.testing.assert_allclose(fills, ref[tag + "/congested_fills"],
                               rtol=0, atol=1e-7)
    assert pump.admission.peek() == bool(ref[tag + "/congested_peek"])
    pump.run_until_drained(max_ticks=8)
    assert list(dataclasses.asdict(pump.stats).values()) == \
        ref[tag + "/congested_stats"].tolist()
    assert pump.pending == int(ref[tag + "/congested_pending"])
    _same_state(ref, tag + "/congested", pump.state)


def test_hold_parks_fresh_submits_and_retarget_keeps_the_backlog():
    mesh = filter_mesh(2, device="cpu")
    pump = DeferredWritePump(
        mesh, "data", dist.make_sharded_state(2, 64, 4, stash_slots=8,
                                              device="cpu"),
        fp_bits=FP, backend="torch")
    hi, lo, _s, _t = _inputs()
    pump.hold()
    ok, dfr = pump.submit(hi[:10], lo[:10])
    assert not ok.any() and dfr.all() and pump.pending == 10
    assert pump.pump() == 0 and pump.stats.held_ticks == 1
    m4 = filter_mesh(4, device="cpu")
    pump.retarget(m4, "data", dist.make_sharded_state(4, 64, 4,
                                                      stash_slots=8,
                                                      device="cpu"))
    pump.release()
    assert pump.n_shards == 4 and pump.pump() == 10 and pump.pending == 0
    assert pump.stats.inserted == 10
    owner = hashing.owner_shard_np(hi[:10], lo[:10], 4)
    live = (pump.state.stacked()[0] != 0).sum(dim=(1, 2)).tolist()
    assert live == np.bincount(owner, minlength=4).tolist()
