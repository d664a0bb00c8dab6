"""Elastic split and merge of the sharded filter (``distributed/elastic.py``)
against the reference's on ``filter_mesh(2)`` / ``filter_mesh(4)``, bit for
bit: the migrated tables and stashes and ``MigrationReport``'s moved,
rounds and failed.  At ``benchmarks/elastic_bench.py``'s geometry (512
buckets, a 128-slot stash, capacity factor 4.0, 3072 keys), with a small
``cap`` that streams several rounds, on a dense state whose merge loses
lanes, and through ``ElasticController`` over a ``DeferredWritePump`` with
writes parked during the cutover.  The reference runs in one subprocess
with four CPU devices; the port in both layouts (every shard in one part,
one part a shard) against the same outputs."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.convert import sharded_state_from_numpy
from repro_torch.core import distributed as dist
from repro_torch.distributed.elastic import (ElasticController,
                                             MigrationReport, filter_mesh,
                                             merge_state, split_state)
from repro_torch.obs import MetricsRegistry, RecoveryMetrics, TraceRecorder
from repro_torch.serving.scheduler import DeferredWritePump

from torch_port_util import (LAYOUTS, REF_JIT_LOOKUP, layout_mesh,
                             random_keys, reference_run, sharded_u32, split,
                             t32)

pytestmark = pytest.mark.tier1

NB, BS, FP, SS, CF = 512, 4, 16, 128, 4.0
N_KEYS, N_CONCURRENT = 3072, 256
# label -> (n_buckets, stash slots, keys, keys added after the split,
#           split cap, merge cap, max_disp)
MIGRATIONS = {"elastic-bench": (NB, SS, N_KEYS, 0, None, None, 64),
              "small-cap": (NB, SS, N_KEYS, 0, 64, 100, 64),
              "dense-merge-fails": (128, 4, 600, 400, None, None, 2)}

SCRIPT = REF_JIT_LOOKUP + """
import json
from repro.core import distributed as dist
from repro.distributed import elastic
from repro.obs import MetricsRegistry, RecoveryMetrics, TraceRecorder
from repro.serving.scheduler import DeferredWritePump
m2, m4 = elastic.filter_mesh(2), elastic.filter_mesh(4)
cases = json.loads(str(IN["cases"]))
for label, (nb, slots, n, extra, scap, mcap, md) in cases.items():
    hi, lo = jnp.asarray(IN["hi"][:n]), jnp.asarray(IN["lo"][:n])
    st = dist.make_sharded_state(2, nb, 4, stash_slots=slots)
    st, ok, dfr, _ = dist.distributed_insert(
        m2, "data", st, hi, lo, fp_bits=16, backend="jnp", route="pair",
        capacity_factor=4.0)
    put(label + "/seed", st, ok=ok, deferred=dfr)
    st4, rep = elastic.split_state(m4, "data", st, cap=scap, max_disp=md)
    put(label + "/split", st4)
    OUT[label + "/split/report"] = np.array(
        [rep.keys_moved, rep.rounds, rep.failed])
    if extra:
        st4, ok, _, _ = dist.distributed_insert(
            m4, "data", st4, jnp.asarray(IN["hi"][n:n + extra]),
            jnp.asarray(IN["lo"][n:n + extra]), fp_bits=16, backend="jnp",
            route="pair", capacity_factor=4.0)
        put(label + "/extra", st4, ok=ok)
    st2, rep = elastic.merge_state(m4, "data", st4, cap=mcap, max_disp=md)
    put(label + "/merge", st2)
    OUT[label + "/merge/report"] = np.array(
        [rep.keys_moved, rep.rounds, rep.failed])

# ElasticController over a pump, with writes parked during the cutover
reg, tr = MetricsRegistry(), TraceRecorder()
rec = RecoveryMetrics(metrics=reg, tracer=tr)
pump = DeferredWritePump(
    m2, "data", dist.make_sharded_state(2, 512, 4, stash_slots=128),
    fp_bits=16, backend="jnp", donate=False, metrics=reg, tracer=tr,
    route="pair", capacity_factor=4.0)
pump.submit(IN["hi"], IN["lo"])
pump.run_until_drained()
ctrl = elastic.ElasticController(pump, axis="data", recovery=rec)
pump.hold()
pump.submit(IN["chi"], IN["clo"])
OUT["ctrl/pending_mid"] = np.array(pump.pending)
rs = ctrl.split(m4)
put("ctrl/split", pump.state)
rm = ctrl.merge(m2)
put("ctrl/merge", pump.state)
OUT["ctrl/reports"] = np.array([[r.keys_moved, r.rounds, r.failed]
                                for r in (rs, rm)])
OUT["ctrl/stats"] = np.array(list(dataclasses.asdict(pump.stats).values()))
OUT["ctrl/pending"] = np.array(pump.pending)
snap = reg.snapshot()
names = sorted(k for k in snap if "seconds" not in k and "_s{" not in k)
OUT["ctrl/metric_names"] = np.array(json.dumps(names))
OUT["ctrl/metric_values"] = np.array([snap[k] for k in names], float)
OUT["ctrl/spans"] = np.array(json.dumps(sorted(
    {e["name"] for e in tr.events})))
"""
SCRIPT = "import dataclasses\n" + SCRIPT


def _keys():
    rng = np.random.RandomState(0)
    hi, lo = split(random_keys(rng, N_KEYS))
    chi, clo = split(random_keys(rng, N_CONCURRENT))
    return hi, lo, chi, clo


@pytest.fixture(scope="module")
def ref():
    import json
    hi, lo, chi, clo = _keys()
    return reference_run(SCRIPT, devices=4, inputs=dict(
        hi=hi, lo=lo, chi=chi, clo=clo,
        cases=np.array(json.dumps(MIGRATIONS))))


def _same_state(ref, tag, state):
    tables, stashes = sharded_u32(state)
    np.testing.assert_array_equal(ref[tag + "/tables"], tables, err_msg=tag)
    np.testing.assert_array_equal(ref[tag + "/stashes"], stashes,
                                  err_msg=tag)


def _live(state) -> int:
    tables, stashes = state.stacked()
    return int((tables != 0).sum() + (stashes[:, 0] != 0).sum())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("label", list(MIGRATIONS))
def test_split_and_merge_match_reference(ref, label, layout):
    nb, slots, n, extra, scap, mcap, md = MIGRATIONS[label]
    hi, lo, _c, _d = _keys()
    m2, m4 = layout_mesh(2, layout), layout_mesh(4, layout)
    st = dist.make_sharded_state(2, nb, 4, stash_slots=slots, mesh=m2)
    st, ok, dfr, _ = dist.distributed_insert(
        m2, "data", st, t32(hi[:n]), t32(lo[:n]), fp_bits=16,
        backend="torch", route="pair", capacity_factor=4.0)
    _same_state(ref, label + "/seed", st)
    np.testing.assert_array_equal(ref[label + "/seed/ok"], ok.numpy())
    before = st.stacked()[0].clone()
    st4, rep = split_state(m4, "data", st, cap=scap, max_disp=md)
    assert torch.equal(st.stacked()[0], before), "the input state is kept"
    assert st4.parts == m4.parts
    _same_state(ref, label + "/split", st4)
    assert [rep.keys_moved, rep.rounds, rep.failed] == \
        ref[label + "/split/report"].tolist()
    assert isinstance(rep, MigrationReport) and rep.direction == "split"
    assert rep.failed == 0 and rep.keys_moved > 0
    if scap is not None:
        assert rep.rounds > 1, "a small cap streams several rounds"
    if extra:
        st4, ok, _, _ = dist.distributed_insert(
            m4, "data", st4, t32(hi[n:n + extra]), t32(lo[n:n + extra]),
            fp_bits=16, backend="torch", route="pair", capacity_factor=4.0)
        _same_state(ref, label + "/extra", st4)
        np.testing.assert_array_equal(ref[label + "/extra/ok"], ok.numpy())
    st2, rep = merge_state(m4, "data", st4, cap=mcap, max_disp=md)
    _same_state(ref, label + "/merge", st2)
    assert [rep.keys_moved, rep.rounds, rep.failed] == \
        ref[label + "/merge/report"].tolist()
    assert st2.n_shards == 2 and rep.new_shards == 2
    assert st2.parts == m2.parts, "the merge keeps the old mesh's first half"
    if label == "dense-merge-fails":
        assert rep.failed > 0, "the dense merge must lose lanes"
    assert _live(st4) == _live(st2) + rep.failed, \
        "live entries are conserved"


def test_split_from_a_reference_state_matches(ref):
    """The port migrates the reference's own seeded state (loaded through
    ``sharded_state_from_numpy``) to the reference's result."""
    seed = sharded_state_from_numpy(ref["elastic-bench/seed/tables"],
                                    ref["elastic-bench/seed/stashes"], NB,
                                    device="cpu")
    st4, _rep = split_state(filter_mesh(4, device="cpu"), "data", seed)
    _same_state(ref, "elastic-bench/split", st4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_controller_over_pump_matches_reference(ref, layout):
    hi, lo, chi, clo = _keys()
    m2, m4 = layout_mesh(2, layout), layout_mesh(4, layout)
    reg, tr = MetricsRegistry(), TraceRecorder()
    rec = RecoveryMetrics(metrics=reg, tracer=tr)
    pump = DeferredWritePump(
        m2, "data", dist.make_sharded_state(2, NB, BS, stash_slots=SS,
                                            mesh=m2),
        fp_bits=FP, backend="torch", donate=False, metrics=reg, tracer=tr,
        route="pair", capacity_factor=CF)
    pump.submit(hi, lo)
    pump.run_until_drained()
    ctrl = ElasticController(pump, axis="data", recovery=rec)
    pump.hold()
    ok, dfr = pump.submit(chi, clo)
    assert not ok.any() and dfr.all()
    assert pump.pending == int(ref["ctrl/pending_mid"]) == N_CONCURRENT
    rs = ctrl.split(m4)
    _same_state(ref, "ctrl/split", pump.state)
    assert pump.state.parts == m4.parts
    rm = ctrl.merge(m2)
    _same_state(ref, "ctrl/merge", pump.state)
    assert pump.state.parts == m2.parts
    assert [[r.keys_moved, r.rounds, r.failed] for r in (rs, rm)] == \
        ref["ctrl/reports"].tolist()
    assert list(dataclasses.asdict(pump.stats).values()) == \
        ref["ctrl/stats"].tolist()
    assert pump.pending == int(ref["ctrl/pending"]) == 0
    import json
    snap = reg.snapshot()
    names = json.loads(str(ref["ctrl/metric_names"]))
    assert [snap[k] for k in names] == ref["ctrl/metric_values"].tolist()
    assert sorted({e["name"] for e in tr.events}) == json.loads(
        str(ref["ctrl/spans"]))
    hits, _ = dist.distributed_lookup(
        m2, "data", pump.state, t32(np.concatenate([hi, chi])),
        t32(np.concatenate([lo, clo])), fp_bits=FP, backend="torch",
        route="pair", capacity_factor=CF)
    assert hits.all(), "no key is lost across the split and the merge"


def test_split_and_merge_refuse_bad_shapes():
    st = dist.make_sharded_state(2, 64, 4, stash_slots=8, device="cpu")
    with pytest.raises(ValueError):
        split_state(filter_mesh(3, device="cpu"), "data", st)
    with pytest.raises(ValueError):
        merge_state(filter_mesh(4, device="cpu"), "data", st)
    no_stash = dist.make_sharded_state(2, 64, 4, stash_slots=0,
                                       device="cpu")
    with pytest.raises(ValueError, match="stashes"):
        split_state(filter_mesh(4, device="cpu"), "data", no_stash)


def test_controller_follows_the_new_mesh_layout():
    """A merge onto a mesh laid out otherwise than the old mesh's first
    half lands the state in the new mesh's parts, each shard's rows
    kept."""
    hi, lo, _c, _d = _keys()
    m2 = filter_mesh(2, device="cpu")
    m4 = layout_mesh(4, "a part a shard")
    pump = DeferredWritePump(
        m2, "data", dist.make_sharded_state(2, NB, BS, stash_slots=SS,
                                            mesh=m2),
        fp_bits=FP, backend="torch", route="pair", capacity_factor=CF)
    pump.submit(hi, lo)
    ctrl = ElasticController(pump, axis="data")
    ctrl.split(m4)
    assert pump.state.parts == m4.parts
    ctrl.merge(m2)
    assert pump.mesh is m2 and pump.state.parts == m2.parts
    hits, _ = dist.distributed_lookup(
        m2, "data", pump.state, t32(hi), t32(lo), fp_bits=FP,
        backend="torch", route="pair", capacity_factor=CF)
    assert hits.all()
