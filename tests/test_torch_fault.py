"""Fault tolerance and checkpoints of the sharded filter
(``distributed/fault.py``, ``checkpoint/ckpt.py``) against the reference's:
the straggler watchdog, restarts and bounded retries, kill and corrupt,
``degraded_lookup`` on ``filter_mesh(2)`` (reference in a subprocess with
two CPU devices), ``recover_shard``, and checkpoints written by either
package restored by the other.  The sharded ones run in both layouts, every
shard in one part and one part a shard, against the same reference
outputs."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import distributed as jdist
from repro.core.ocf import OCF as RefOCF, OcfConfig as RefConfig
from repro.distributed import fault as jfault
from repro.obs import MetricsRegistry as RefRegistry
from repro_torch.checkpoint import ckpt
from repro_torch.convert import sharded_state_from_numpy
from repro_torch.core import distributed as dist
from repro_torch.core.ocf import OCF, OcfConfig
from repro_torch.distributed import fault
from repro_torch.obs import MetricsRegistry, RecoveryMetrics

from torch_port_util import (LAYOUTS, REF_JIT_LOOKUP, layout_mesh,
                             port_snapshot, random_keys, ref_snapshot,
                             reference_run, sharded_u32, split, t32)

pytestmark = pytest.mark.tier1


def test_straggler_watchdog_matches_reference():
    times = [0.1, 0.11, 0.09, 0.5, 0.1, 0.12, 1.0, 0.1, 0.35, 0.31]
    ref_reg, reg = RefRegistry(), MetricsRegistry()
    ref_w = jfault.StragglerWatchdog(factor=3.0, history=4, metrics=ref_reg)
    w = fault.StragglerWatchdog(factor=3.0, history=4, metrics=reg)
    assert [ref_w.observe(t) for t in times] == [w.observe(t) for t in times]
    assert w.flagged == ref_w.flagged > 0
    assert reg.snapshot() == ref_reg.snapshot()


def _restart_trace(mod, fail_times, max_restarts):
    seen = []

    def make_state(step):
        seen.append(("make", step))
        return {"step": step}

    calls = [0]

    def run_from(state):
        calls[0] += 1
        if calls[0] <= fail_times:
            raise RuntimeError(f"boom {calls[0]}")
        return ("done", calls[0])

    policy = mod.RestartPolicy(max_restarts=max_restarts, backoff_s=0.0)
    try:
        out = mod.run_with_restarts(make_state, run_from, policy,
                                    latest_step_fn=lambda: len(seen))
    except RuntimeError as e:
        out = ("raised", str(e))
    return out, seen


@pytest.mark.parametrize("fail_times", [0, 2, 4])
def test_run_with_restarts_matches_reference(fail_times):
    assert _restart_trace(fault, fail_times, 3) == _restart_trace(
        jfault, fail_times, 3)


@pytest.mark.parametrize("fail_times", [0, 3, 6])
def test_retry_routed_write_matches_reference(fail_times):
    def trace(mod):
        sleeps = []
        inj = mod.FaultInjector()
        attempt = inj.failing(lambda: "written", fail_times)
        policy = mod.RestartPolicy(max_restarts=4, backoff_s=0.5)
        try:
            out = mod.retry_routed_write(attempt, policy,
                                         sleep=sleeps.append)
        except mod.InjectedFault as e:
            out = ("raised", str(e))
        return out, sleeps
    assert trace(fault) == trace(jfault)


def _numpy_state(seed=1, shards=3):
    rng = np.random.RandomState(seed)
    tables = rng.randint(0, 2**32, (shards, 32, 4)).astype(np.uint32)
    tables[rng.rand(*tables.shape) < 0.4] = 0
    stashes = rng.randint(0, 2**32, (shards, 2, 8)).astype(np.uint32)
    return tables, stashes


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kill_and_corrupt_match_reference(layout):
    tables, stashes = _numpy_state()
    ref_st = jdist.ShardedFilterState(tables, stashes, 32)
    st = sharded_state_from_numpy(tables, stashes, 32,
                                  mesh=layout_mesh(3, layout))
    rec_reg = MetricsRegistry()
    ref_inj, inj = jfault.FaultInjector(), fault.FaultInjector(
        recovery=RecoveryMetrics(metrics=rec_reg))
    for name, args in (("kill", (1,)), ("corrupt", (2, 5))):
        ref_st = getattr(ref_inj, name)(ref_st, *args)
        before = st.stacked()[0].clone()
        new = getattr(inj, name)(st, *args)
        got_t, got_s = sharded_u32(new)
        np.testing.assert_array_equal(np.asarray(ref_st.tables), got_t)
        np.testing.assert_array_equal(np.asarray(ref_st.stashes), got_s)
        assert new.parts == st.parts
        assert torch.equal(st.stacked()[0], before), "the input is kept"
        st = new
    assert inj.lost == ref_inj.lost == {1, 2}
    assert rec_reg.snapshot()['shard_faults{kind="kill"}'] == 1
    inj.heal(1)
    ref_inj.heal(1)
    assert inj.lost == ref_inj.lost == {2}


def test_delay_and_failing_wrappers():
    inj = fault.FaultInjector()
    slow = inj.delay(lambda x: x + 1, 0.0)
    assert slow(1) == 2
    flaky = inj.failing(lambda: 7, 2)
    for _ in range(2):
        with pytest.raises(fault.InjectedFault):
            flaky()
    assert flaky() == 7


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_sharded_checkpoints_cross_restore(tmp_path, direction, layout):
    tables, stashes = _numpy_state(seed=2)
    d = str(tmp_path)
    mesh = layout_mesh(3, layout)
    if direction == "reference-to-port":
        jckpt.save_sharded(d, 3, jdist.ShardedFilterState(
            jnp.asarray(tables), jnp.asarray(stashes), 32))
        got = ckpt.restore_sharded(d, mesh=mesh)
        got_t, got_s = sharded_u32(got)
        np.testing.assert_array_equal(got_t, tables)
        np.testing.assert_array_equal(got_s, stashes)
        assert got.n_buckets == 32 and got.parts == mesh.parts
        assert got.table_parts[0].dtype == torch.int32
        if layout == "a part a shard":
            again = ckpt.restore_sharded(d, devices=["cpu"] * 3)
            assert again.parts == mesh.parts
    else:
        ckpt.save_sharded(d, 3, sharded_state_from_numpy(
            tables, None, None, mesh=mesh))
        got = jckpt.restore_sharded(d)
        np.testing.assert_array_equal(np.asarray(got.tables), tables)
        assert got.stashes is None and got.n_buckets is None
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 3


def test_tree_checkpoints_cross_restore(tmp_path):
    """Generic trees (dicts, lists, NamedTuples, bfloat16 leaves) in the
    same files and manifest: each package restores the other's."""
    rng = np.random.RandomState(3)
    w = rng.randn(4, 3).astype(np.float32)
    ids = np.arange(5, dtype=np.int64)
    tree = {"w": w, "layers": [ids, {"b": np.float32(2.5)}],
            "st": jdist.ShardedFilterState(np.uint32([[[1]]]), None, None)}
    ckpt.save(str(tmp_path / "p"), 1, tree, extra={"k": 1})
    jckpt.save(str(tmp_path / "r"), 1, tree, extra={"k": 1})
    for d in ("p", "r"):
        names = sorted(os.listdir(tmp_path / d / "step_00000001"))
        assert names == sorted(os.listdir(tmp_path / "r" / "step_00000001"))
        mine, m1 = ckpt.restore(str(tmp_path / d), 1, tree)
        theirs, m2 = jckpt.restore(str(tmp_path / d), 1, tree)
        assert m1 == m2 and m1["extra"] == {"k": 1}
        np.testing.assert_array_equal(mine["w"], theirs["w"])
        np.testing.assert_array_equal(mine["layers"][0], ids)
        assert float(mine["layers"][1]["b"]) == 2.5
        np.testing.assert_array_equal(mine["st"].tables, [[[1]]])
    bf = torch.arange(6, dtype=torch.float32).reshape(2, 3).bfloat16()
    ckpt.save(str(tmp_path / "bf"), 2, {"x": bf})
    back, _ = ckpt.restore(str(tmp_path / "bf"), 2, {"x": 0})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], bf)
    theirs, _ = jckpt.restore(str(tmp_path / "bf"), 2, {"x": 0})
    np.testing.assert_array_equal(np.asarray(theirs["x"], np.float32),
                                  bf.float().numpy())
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path / "bf"), 2, {"y": 0})


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    x = torch.zeros(3)
    for step in range(4):
        x += 1
        ac.save(step, {"x": x})
    ac.join()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    back, _ = ckpt.restore(str(tmp_path), 3, {"x": 0})
    np.testing.assert_array_equal(back["x"], [4.0, 4.0, 4.0])


def test_ocf_checkpoint_restores_in_either_package(tmp_path):
    keys = random_keys(np.random.RandomState(4), 3000)
    ref = RefOCF(RefConfig(capacity=4096, backend="pallas"))
    ref.insert(keys)
    jckpt.save(str(tmp_path), 5, {"w": np.ones(2)}, ocf=ref)
    port = ckpt.restore_ocf(str(tmp_path), 5, OCF(OcfConfig(
        capacity=4096, device="cpu")))
    again = jckpt.restore_ocf(str(tmp_path), 5, RefOCF(RefConfig(
        capacity=4096, backend="pallas")))
    want, got = ref_snapshot(again), port_snapshot(port)
    np.testing.assert_array_equal(want["table"], got["table"])
    assert want["count"] == got["count"]
    ckpt.save(str(tmp_path / "p"), 6, {}, ocf=port)
    np.testing.assert_array_equal(
        np.load(tmp_path / "p" / "step_00000006" / "ocf_keys.npy"),
        np.load(tmp_path / "step_00000005" / "ocf_keys.npy"))


DEGRADED_SCRIPT = REF_JIT_LOOKUP + """
from repro.checkpoint import ckpt
from repro.core import distributed as dist
from repro.distributed import fault
from repro.distributed.elastic import filter_mesh
mesh = filter_mesh(2)
hi, lo = jnp.asarray(IN["hi"]), jnp.asarray(IN["lo"])
qh, ql = jnp.asarray(IN["qh"]), jnp.asarray(IN["ql"])
for route in ("key", "pair"):
    st = dist.make_sharded_state(2, 256, 4, stash_slots=16)
    st, ok, _, _ = dist.distributed_insert(mesh, "data", st, hi, lo,
                                           fp_bits=16, backend="jnp",
                                           route=route)
    d = IN["dir"].item() + "/" + route
    ckpt.save_sharded(d, 1, st)
    healthy, _ = lookup(mesh, st, qh, ql, fp_bits=16, backend="jnp",
                        route=route)
    inj = fault.FaultInjector()
    dead = inj.kill(st, 1)
    out, ov, deg = fault.degraded_lookup(mesh, "data", dead, qh, ql,
                                         fp_bits=16, injector=inj,
                                         route=route, backend="jnp")
    back = fault.recover_shard(dead, 1, ckpt_dir=d, injector=inj)
    after, _ = lookup(mesh, back, qh, ql, fp_bits=16, backend="jnp",
                      route=route)
    OUT[route + "/healthy"], OUT[route + "/degraded_hits"] = healthy, out
    OUT[route + "/degraded"], OUT[route + "/overflow"] = deg, ov
    OUT[route + "/after"] = after
    OUT[route + "/lost_after"] = np.array(len(inj.lost))
    put(route + "/dead", dead)
    put(route + "/recovered", back)
"""


@pytest.fixture(scope="module")
def degraded_ref(tmp_path_factory):
    rng = np.random.RandomState(6)
    hi, lo = split(random_keys(rng, 1500))
    qh, ql = split(np.concatenate([random_keys(np.random.RandomState(6),
                                               1500)[:800],
                                   random_keys(rng, 800)]))
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    out = reference_run(DEGRADED_SCRIPT, devices=2, inputs=dict(
        hi=hi, lo=lo, qh=qh, ql=ql, dir=np.array(d)))
    return out, (hi, lo, qh, ql), d


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("route", ["key", "pair"])
def test_degraded_lookup_and_recovery_match_reference(degraded_ref,
                                                      tmp_path, route,
                                                      layout):
    ref, (hi, lo, qh, ql), ref_dir = degraded_ref
    mesh = layout_mesh(2, layout)
    st = dist.make_sharded_state(2, 256, 4, stash_slots=16, mesh=mesh)
    st, ok, _, _ = dist.distributed_insert(mesh, "data", st, t32(hi),
                                           t32(lo), fp_bits=16,
                                           backend="torch", route=route)
    ckpt.save_sharded(str(tmp_path), 1, st)
    healthy, _ = dist.distributed_lookup(mesh, "data", st, t32(qh), t32(ql),
                                         fp_bits=16, backend="torch",
                                         route=route)
    np.testing.assert_array_equal(ref[route + "/healthy"], healthy.numpy())
    reg = MetricsRegistry()
    rec = RecoveryMetrics(metrics=reg)
    inj = fault.FaultInjector(recovery=rec)
    dead = inj.kill(st, 1)
    np.testing.assert_array_equal(ref[route + "/dead/tables"],
                                  sharded_u32(dead)[0])
    out, ov, deg = fault.degraded_lookup(mesh, "data", dead, t32(qh),
                                         t32(ql), fp_bits=16, injector=inj,
                                         route=route, backend="torch",
                                         recovery=rec)
    np.testing.assert_array_equal(ref[route + "/degraded_hits"], out)
    np.testing.assert_array_equal(ref[route + "/degraded"], deg)
    np.testing.assert_array_equal(ref[route + "/overflow"], ov.numpy())
    assert out[deg].all() and deg.any() and not deg.all()
    np.testing.assert_array_equal(out[~deg], healthy.numpy()[~deg])
    assert reg.snapshot()["degraded_lookup_answers"] == int(deg.sum())
    # the port recovers from the reference's snapshot and from its own
    for d in (str(tmp_path), os.path.join(ref_dir, route)):
        back = fault.recover_shard(dead, 1, ckpt_dir=d, injector=inj,
                                   recovery=rec)
        got_t, got_s = sharded_u32(back)
        np.testing.assert_array_equal(ref[route + "/recovered/tables"],
                                      got_t)
        np.testing.assert_array_equal(ref[route + "/recovered/stashes"],
                                      got_s)
        assert back.parts == mesh.parts
        after, _ = dist.distributed_lookup(mesh, "data", back, t32(qh),
                                           t32(ql), fp_bits=16,
                                           backend="torch", route=route)
        assert torch.equal(after, healthy)
    assert not inj.lost and int(ref[route + "/lost_after"]) == 0
    assert 'elastic_time_to_recover_s{event="shard_restore"}' in \
        reg.snapshot()


def test_restart_policy_fields_match_reference():
    assert dataclasses.asdict(fault.RestartPolicy()) == dataclasses.asdict(
        jfault.RestartPolicy())
