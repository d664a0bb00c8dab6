"""The telemetry twins: ``repro_torch.kernels.telemetry`` and every
``FilterOps.*_tm`` of the port against the reference's
(``repro.core.filter_ops.FilterOps(backend="pallas")``) on the same state
and keys, bit for bit: results, tables, selector and key planes, stashes,
counts and all nine counter fields.  The cases drive every counter off
zero: small tables near load 0.95 with a few stash slots and 2-4 eviction
rounds (kicks, spills, rollbacks), ``evict_rounds=0`` with a stash,
deletes that resolve in the stash, and reports that bump selectors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adaptive.state import make_adaptive_state as ref_adaptive_state
from repro.core import filter as jfilter
from repro.core.filter_ops import FilterOps as RefOps
from repro.kernels import ops as ref_kops
from repro.kernels import telemetry as ref_tm
from repro.kernels.probe import (probe_adaptive_emulated_tm,
                                 probe_emulated_tm)
from repro_torch.convert import (adaptive_state_from_numpy,
                                 adaptive_state_to_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core.filter_ops import FilterOps
from repro_torch.kernels import ops as kops
from repro_torch.kernels import telemetry as tmod
from repro_torch.kernels.probe import probe_adaptive_tm, probe_tm
from repro_torch.kernels.staging_cases import (PROBE_DEPTH_CASES,
                                               probe_adaptive_inputs,
                                               probe_inputs)

from torch_port_util import random_keys, split, t32, u32

pytestmark = pytest.mark.tier1

WAVE = 64


def _assert_tm(ref, port, where=""):
    assert ref._fields == port._fields
    for name, r, p in zip(ref._fields, ref, port):
        r = np.asarray(r).astype(np.int64)
        p = p.numpy()
        assert p.dtype == np.int64, (where, name)
        np.testing.assert_array_equal(p, r, err_msg=f"{where} {name}")


def _keys(keys):
    hi, lo = split(keys)
    return (jnp.asarray(hi), jnp.asarray(lo)), (t32(hi), t32(lo))


# ------------------------------------------------- the counter helpers ---


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_helpers_match_reference(seed):
    rng = np.random.RandomState(seed)
    steps = rng.randint(0, 70, size=300).astype(np.int32)
    steps[:40] = rng.choice([0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33], 40)
    mask = rng.rand(300) < 0.8
    np.testing.assert_array_equal(
        tmod.kick_histogram(torch.from_numpy(steps),
                            torch.from_numpy(mask)).numpy(),
        np.asarray(ref_tm.kick_histogram(jnp.asarray(steps),
                                         jnp.asarray(mask))))
    h = rng.rand(4, 300) < 0.3
    np.testing.assert_array_equal(
        tmod.probe_depth_counts(*(torch.from_numpy(x) for x in h)).numpy(),
        np.asarray(ref_tm.probe_depth_counts(*(jnp.asarray(x) for x in h))))
    _assert_tm(ref_tm.empty_telemetry(), tmod.empty_telemetry())
    a, b = _random_planes(rng)
    _assert_tm(ref_tm.merge(_to_ref(a), _to_ref(b)), tmod.merge(a, b))


def _random_planes(rng, k=2):
    """k planes with values up to 2^32 - 1, so that sums wrap."""
    out = []
    for _ in range(k):
        flat = rng.randint(0, 2**32, size=tmod.PLANE_SIZE, dtype=np.int64)
        flat[rng.rand(tmod.PLANE_SIZE) < 0.3] = 2**32 - 1
        out.append(tmod.unpack(torch.from_numpy(flat)))
    return out


def _to_ref(tm):
    return ref_tm.FilterTelemetry(*(jnp.asarray(f.numpy().astype(np.uint32))
                                    for f in tm))


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_merge_associative_and_commutative(seed):
    a, b, c = _random_planes(np.random.RandomState(seed), 3)

    def same(x, y):
        for f, g in zip(x, y):
            assert torch.equal(f, g)
    same(tmod.merge(a, b), tmod.merge(b, a))
    same(tmod.merge(tmod.merge(a, b), c), tmod.merge(a, tmod.merge(b, c)))
    same(tmod.merge(a, tmod.empty_telemetry()), a)
    for f in tmod.merge(a, b):
        assert int(f.min()) >= 0 and int(f.max()) < 2**32


def test_empty_telemetry_is_fresh():
    a = tmod.empty_telemetry()
    a.kick_hist.add_(1)
    assert int(tmod.empty_telemetry().kick_hist.sum()) == 0


# ------------------------------------------------- static twins ---------


def _static_pair(nb, rounds, schedule, stash_slots, load, seed):
    """The reference's and the port's (ops, state, stash), filled to
    ``load`` by the reference and mirrored into the port."""
    ref_ops = RefOps(fp_bits=12, backend="pallas", evict_rounds=rounds,
                     schedule=schedule)
    ops = FilterOps(fp_bits=12, backend="cuda", evict_rounds=rounds,
                    schedule=schedule)
    rng = np.random.RandomState(seed)
    fill = random_keys(rng, int(load * nb * 4))
    state = jfilter.make_state(nb, 4)
    (rhi, rlo), _ = _keys(fill)
    state, ok = RefOps(fp_bits=12, backend="pallas",
                       evict_rounds=64).insert(state, rhi, rlo)
    fill = fill[np.asarray(ok)]
    rstash = ref_kops.make_stash(stash_slots) if stash_slots else None
    pstate, pstash = state_from_numpy(
        np.asarray(state.table), int(state.count), nb,
        None if rstash is None else np.asarray(rstash), device="cpu")
    return (ref_ops, state, rstash), (ops, pstate, pstash), rng, fill


def _same_static(ref, port, where):
    rstate, rstash = ref
    pstate, pstash = port
    got = state_to_numpy(pstate, pstash)
    np.testing.assert_array_equal(got["table"], np.asarray(rstate.table),
                                  err_msg=where)
    assert got["count"] == int(rstate.count), where
    if rstash is not None:
        np.testing.assert_array_equal(got["stash"], np.asarray(rstash),
                                      err_msg=where)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("rounds,stash_slots", [(2, 8), (4, 4), (0, 8),
                                                (3, 0)])
def test_static_twins_match_reference(rounds, stash_slots, schedule):
    """Inserts near load 0.95 (kicks, spills, rollbacks), lookups of
    resident, spilled and absent keys, deletes that clear table and stash
    entries: every result, state and counter equals the reference's."""
    (rops, rstate, rstash), (ops, pstate, pstash), rng, fill = _static_pair(
        64, rounds, schedule, stash_slots, 0.85, seed=rounds + stash_slots)
    seen = np.zeros(tmod.PLANE_SIZE, np.int64)
    inserted = []
    for w in range(3):
        keys = random_keys(rng, WAVE)
        valid = rng.rand(WAVE) < 0.9
        (rhi, rlo), (hi, lo) = _keys(keys)
        rv, pv = jnp.asarray(valid), torch.from_numpy(valid)
        if rstash is None:
            rstate, rok, rtm = rops.insert_tm(rstate, rhi, rlo, valid=rv)
            pstate, pok, ptm = ops.insert_tm(pstate, hi, lo, valid=pv)
        else:
            rstate, rstash, rok, rtm = rops.insert_spill_tm(
                rstate, rstash, rhi, rlo, valid=rv)
            pstate, pstash, pok, ptm = ops.insert_spill_tm(
                pstate, pstash, hi, lo, valid=pv)
        np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
        _assert_tm(rtm, ptm, f"insert {w}")
        assert int(ptm.kick_hist.sum()) == int(valid.sum())
        _same_static((rstate, rstash), (pstate, pstash), f"insert {w}")
        seen += tmod.pack(ptm).numpy()
        inserted.append(keys[pok.numpy()])
    inserted = np.concatenate(inserted)
    probe = np.concatenate([inserted[:WAVE // 2], fill[:WAVE // 4],
                            random_keys(rng, WAVE // 4)])
    (rhi, rlo), (hi, lo) = _keys(probe)
    if rstash is None:
        rhit, rtm = rops.lookup_tm(rstate, rhi, rlo)
        phit, ptm = ops.lookup_tm(pstate, hi, lo)
    else:
        rhit, rtm = rops.lookup_with_stash_tm(rstate, rstash, rhi, rlo)
        phit, ptm = ops.lookup_with_stash_tm(pstate, pstash, hi, lo)
    np.testing.assert_array_equal(phit.numpy(), np.asarray(rhit))
    _assert_tm(rtm, ptm, "lookup")
    seen += tmod.pack(ptm).numpy()
    # deletes of every acknowledged key (the spilled ones clear stash
    # entries), a wave at a time
    every = np.concatenate([fill, inserted])
    for w in range(0, every.size - WAVE + 1, WAVE):
        (rhi, rlo), (hi, lo) = _keys(every[w:w + WAVE])
        if rstash is None:
            rstate, rok, rtm = rops.delete_tm(rstate, rhi, rlo)
            pstate, pok, ptm = ops.delete_tm(pstate, hi, lo)
        else:
            rtable, rstash, rok, rtm = ref_kops.filter_delete_tm(
                rstate.table, rhi, rlo, fp_bits=12, n_buckets=64,
                stash=rstash)
            ptable, pstash, pok, ptm = kops.filter_delete_tm(
                pstate.table, hi, lo, fp_bits=12, n_buckets=64,
                stash=pstash)
            np.testing.assert_array_equal(u32(ptable), np.asarray(rtable))
            np.testing.assert_array_equal(u32(pstash), np.asarray(rstash))
            rstate = rstate._replace(table=rtable)
            pstate = pstate._replace(table=ptable)
        np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
        _assert_tm(rtm, ptm, f"delete {w}")
        assert pok.all()
        _same_static((rstate, rstash), (pstate, pstash), f"delete {w}")
        seen += tmod.pack(ptm).numpy()
    tm = tmod.unpack(torch.from_numpy(seen))
    # every counter these cases can reach came off zero
    assert int(tm.kick_hist[1:].sum()) > 0 or rounds == 0
    assert int(tm.rollback_lanes) > 0 or rounds == 0 or stash_slots
    if stash_slots:
        assert int(tm.stash_spills) > 0 and int(tm.stash_fill_hw) > 0
        assert int(tm.probe_depth[2]) > 0 and int(tm.stash_deletes) > 0
    assert int(tm.probe_depth[1]) > 0 and int(tm.probe_depth[3]) > 0
    assert int(tm.table_deletes) > 0


def test_rollbacks_with_a_full_stash():
    """A 4-slot stash fills in the first wave; later chains roll back."""
    (rops, rstate, rstash), (ops, pstate, pstash), rng, _ = _static_pair(
        64, 2, False, 4, 0.9, seed=11)
    total = 0
    for w in range(2):
        (rhi, rlo), (hi, lo) = _keys(random_keys(rng, WAVE))
        rstate, rstash, rok, rtm = rops.insert_spill_tm(rstate, rstash,
                                                        rhi, rlo)
        pstate, pstash, pok, ptm = ops.insert_spill_tm(pstate, pstash, hi,
                                                       lo)
        np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
        _assert_tm(rtm, ptm, f"wave {w}")
        total += int(ptm.rollback_lanes)
    _same_static((rstate, rstash), (pstate, pstash), "end")
    assert int(ptm.stash_fill_hw) == 4 and total > 0


def test_filter_lookup_and_stash_delete_match_reference():
    (_r, rstate, rstash), (_p, pstate, pstash), rng, fill = _static_pair(
        64, 2, False, 8, 0.9, seed=5)
    extra = random_keys(rng, WAVE)
    (rhi, rlo), (hi, lo) = _keys(extra)
    rtable, rstash, _ok = ref_kops.filter_insert(
        rstate.table, rhi, rlo, fp_bits=12, n_buckets=64, evict_rounds=2,
        stash=rstash)
    ptable, pstash, _ok = kops.filter_insert(
        pstate.table, hi, lo, fp_bits=12, n_buckets=64, evict_rounds=2,
        stash=pstash)
    assert int((u32(pstash)[0] != 0).sum()) > 0
    probe = np.concatenate([extra, fill[:32], random_keys(rng, 32)])
    (rhi, rlo), (hi, lo) = _keys(probe)
    for rs, ps in ((None, None), (rstash, pstash)):
        np.testing.assert_array_equal(
            kops.filter_lookup(ptable, hi, lo, fp_bits=12, n_buckets=64,
                               stash=ps).numpy(),
            np.asarray(ref_kops.filter_lookup(rtable, rhi, rlo, fp_bits=12,
                                              n_buckets=64, stash=rs)))
    # every acknowledged key (the spilled ones clear stash entries), and
    # some twice: a second copy of a key resolves nowhere
    gone = np.concatenate([fill, extra, extra[:8]])
    valid = np.ones(gone.size, bool)
    valid[3] = False
    (rhi, rlo), (hi, lo) = _keys(gone)
    rt, rs, rok = ref_kops.filter_delete(rtable, rhi, rlo, fp_bits=12,
                                         n_buckets=64, stash=rstash,
                                         valid=jnp.asarray(valid))
    before = pstash.clone()
    pt, ps, pok = kops.filter_delete(ptable, hi, lo, fp_bits=12,
                                     n_buckets=64, stash=pstash,
                                     valid=torch.from_numpy(valid))
    assert torch.equal(pstash, before)            # not donated: a copy
    np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(u32(pt), np.asarray(rt))
    np.testing.assert_array_equal(u32(ps), np.asarray(rs))
    assert int((u32(ps)[0] != 0).sum()) < int((u32(pstash)[0] != 0).sum())


# ------------------------------------------------- adaptive twins -------


def _same_adaptive(rstate, rstash, pstate, pstash, where):
    got = adaptive_state_to_numpy(pstate)
    for plane in ("table", "sels", "khi", "klo"):
        np.testing.assert_array_equal(got[plane],
                                      np.asarray(getattr(rstate, plane)),
                                      err_msg=f"{where} {plane}")
    assert got["count"] == int(rstate.count), where
    if rstash is not None:
        np.testing.assert_array_equal(u32(pstash), np.asarray(rstash),
                                      err_msg=where)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("rounds,stash_slots", [(2, 8), (0, 4), (3, 0)])
def test_adaptive_twins_match_reference(rounds, stash_slots, schedule):
    """Inserts to load ~0.95 over 64 buckets, lookups, reports of the
    false positives (selector bumps), deletes that resolve in the stash."""
    nb = 64
    rops = RefOps(fp_bits=8, backend="pallas", evict_rounds=rounds,
                  schedule=schedule)
    ops = FilterOps(fp_bits=8, backend="cuda", evict_rounds=rounds,
                    schedule=schedule)
    rstate = ref_adaptive_state(nb)
    d = {k: np.asarray(getattr(rstate, k)) for k in
         ("table", "sels", "khi", "klo")}
    pstate = adaptive_state_from_numpy(d["table"], d["sels"], d["khi"],
                                       d["klo"], 0, nb, device="cpu")
    rstash = ref_kops.make_stash(stash_slots) if stash_slots else None
    pstash = (None if rstash is None
              else t32(np.asarray(rstash)))
    rng = np.random.RandomState(20 + rounds)
    seen = np.zeros(tmod.PLANE_SIZE, np.int64)
    members = []

    def add(ptm):
        nonlocal seen
        seen = seen + tmod.pack(ptm).numpy()

    for w in range(4):
        keys = random_keys(rng, WAVE)
        (rhi, rlo), (hi, lo) = _keys(keys)
        rout = rops.insert_adaptive_tm(rstate, rhi, rlo, stash=rstash)
        pout = ops.insert_adaptive_tm(pstate, hi, lo, stash=pstash)
        rstate, pstate = rout[0], pout[0]
        if rstash is not None:
            rstash, pstash = rout[1], pout[1]
        np.testing.assert_array_equal(pout[-2].numpy(),
                                      np.asarray(rout[-2]))
        _assert_tm(rout[-1], pout[-1], f"insert {w}")
        _same_adaptive(rstate, rstash, pstate, pstash, f"insert {w}")
        add(pout[-1])
        members.append(keys[pout[-2].numpy()])
    members = np.concatenate(members)
    benign = random_keys(rng, WAVE)
    probe = np.concatenate([members[:WAVE // 2], benign[:WAVE // 2]])
    (rhi, rlo), (hi, lo) = _keys(probe)
    rhit, rtm = rops.lookup_adaptive_tm(rstate, rhi, rlo, stash=rstash)
    phit, ptm = ops.lookup_adaptive_tm(pstate, hi, lo, stash=pstash)
    np.testing.assert_array_equal(phit.numpy(), np.asarray(rhit))
    _assert_tm(rtm, ptm, "lookup")
    add(ptm)
    # every benign key that false-positives is reported
    (rhi, rlo), (hi, lo) = _keys(benign)
    rstate, radapt, rres, rtm = rops.report_false_positive_tm(rstate, rhi,
                                                              rlo)
    pstate, padapt, pres, ptm = ops.report_false_positive_tm(pstate, hi, lo)
    np.testing.assert_array_equal(padapt.numpy(), np.asarray(radapt))
    np.testing.assert_array_equal(pres.numpy(), np.asarray(rres))
    _assert_tm(rtm, ptm, "report")
    _same_adaptive(rstate, rstash, pstate, pstash, "report")
    add(ptm)
    # every member, a wave at a time (the spilled ones clear stash entries)
    for w in range(0, members.size - WAVE + 1, WAVE):
        (rhi, rlo), (hi, lo) = _keys(members[w:w + WAVE])
        rout = rops.delete_adaptive_tm(rstate, rhi, rlo, stash=rstash)
        pout = ops.delete_adaptive_tm(pstate, hi, lo, stash=pstash)
        rstate, pstate = rout[0], pout[0]
        if rstash is not None:
            rstash, pstash = rout[1], pout[1]
        np.testing.assert_array_equal(pout[-2].numpy(),
                                      np.asarray(rout[-2]))
        assert pout[-2].all()
        _assert_tm(rout[-1], pout[-1], f"delete {w}")
        _same_adaptive(rstate, rstash, pstate, pstash, f"delete {w}")
        add(pout[-1])
    tm = tmod.unpack(torch.from_numpy(seen))
    assert int(tm.selector_bumps) > 0 and int(tm.table_deletes) > 0
    assert int(tm.probe_depth[0]) > 0 and int(tm.probe_depth[3]) > 0
    if rounds:
        assert int(tm.kick_hist[1:].sum()) > 0
    if stash_slots:
        assert int(tm.stash_spills) > 0 and int(tm.stash_deletes) > 0
    elif rounds:
        assert int(tm.rollback_lanes) > 0


# ------------------------------------------------- the probe planes ----


@pytest.mark.parametrize("label", PROBE_DEPTH_CASES)
def test_probe_cases_depth_plane_match_reference(label):
    """``probe_tm`` (the plain version here) on the PROBE_CASES whose
    counted keys reach every depth (PROBE_DEPTH_CASES;
    tests/test_torch_probe.py holds every case against the reference):
    answers for every lane, and the depth plane of the counted lanes, equal
    the reference's ``probe_emulated_tm`` over the counted keys alone (the
    padding key 0 is planted and must not count)."""
    c = probe_inputs(label, 0)
    hi, lo = split(c["keys"])
    k = c["counted"]
    for stash in (None, c["stash"]):
        kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"])
        hit, plane = probe_tm(t32(c["table"]), t32(hi), t32(lo), n_valid=k,
                              stash=None if stash is None else t32(stash),
                              block=c["block"], **kw)
        rhit, rdepth = probe_emulated_tm(
            jnp.asarray(c["table"]), jnp.asarray(hi[:k]), jnp.asarray(lo[:k]),
            c["n_buckets"], None if stash is None else jnp.asarray(stash),
            fp_bits=c["fp_bits"])
        np.testing.assert_array_equal(hit[:k].numpy(), np.asarray(rhit))
        np.testing.assert_array_equal(plane.numpy(),
                                      np.asarray(rdepth).astype(np.int64))
        assert int(plane.sum()) == k
        assert bool(hit[k:].all())                # the padding key hits
        assert int(plane[0]) > 0 and int(plane[1]) > 0
        if stash is not None:
            assert int(plane[2]) > 0


@pytest.mark.parametrize("label", ["stash-128-full", "n-1000", "bucket-2",
                                   "wrong-selector"])
def test_probe_adaptive_depth_plane_matches_reference(label):
    """``probe_adaptive_tm`` (the plain version here) on
    PROBE_ADAPTIVE_CASES, the last 7 lanes uncounted."""
    c = probe_adaptive_inputs(label, 0)
    hi, lo = split(c["keys"])
    k = c["keys"].size - 7
    hit, plane = probe_adaptive_tm(
        t32(c["table"]), t32(c["sels"]), t32(hi), t32(lo),
        fp_bits=c["fp_bits"], n_buckets=c["n_buckets"],
        stash=t32(c["stash"]), n_valid=k, block=c["block"])
    rhit, rdepth = probe_adaptive_emulated_tm(
        jnp.asarray(c["table"]), jnp.asarray(c["sels"]), jnp.asarray(hi[:k]),
        jnp.asarray(lo[:k]), c["n_buckets"], jnp.asarray(c["stash"]),
        fp_bits=c["fp_bits"])
    np.testing.assert_array_equal(hit[:k].numpy(), np.asarray(rhit))
    np.testing.assert_array_equal(plane.numpy(),
                                  np.asarray(rdepth).astype(np.int64))
    assert int(plane.sum()) == k
