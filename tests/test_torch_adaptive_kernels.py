"""Kernels 6-9 (fingerprint_hash_family, probe_adaptive,
insert_bulk_adaptive, delete_bulk_adaptive): the port's plain versions
against the reference's XLA grid emulation on the same inputs, bit for
bit (all four planes, the stash and the ok masks), one tiny case each
against the Pallas interpreter, the single-lane ``PyAdaptiveFilter``
oracle, and the zero-selector-plane identity with the static kernels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delete import delete_bulk_adaptive as ref_delete
from repro.kernels.fingerprint import fingerprint_hash_family as ref_family
from repro.kernels.insert import insert_bulk_adaptive as ref_insert
from repro.kernels.probe import probe_adaptive as ref_probe
from repro.streaming.oracle import PyAdaptiveFilter
from repro_torch.kernels import ops
from repro_torch.kernels.delete import delete_bulk, delete_bulk_adaptive
from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                             fingerprint_hash_family)
from repro_torch.kernels.insert import insert_bulk, insert_bulk_adaptive
from repro_torch.kernels.probe import probe, probe_adaptive

from torch_port_util import (ADAPTIVE_STAGING_CASES, adaptive_planes,
                             adaptive_staging_inputs, random_keys, split,
                             t32, u32)

pytestmark = pytest.mark.tier1


def _ref_kw(interpret):
    return dict(interpret=True) if interpret else dict(emulate=True)


def _same(port, ref):
    """Port tensors (int32 bits / bool) against reference arrays."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p = p.numpy()
        np.testing.assert_array_equal(
            p.view(np.uint32) if p.dtype == np.int32 else p, np.asarray(r))


def _insert_both(planes, stash, keys, valid, *, nb, block, rounds, fp_bits,
                 schedule=False, interpret=False):
    hi, lo = split(keys)
    kw = dict(fp_bits=fp_bits, n_buckets=nb, evict_rounds=rounds,
              block=block, schedule=schedule)
    ref = ref_insert(*(jnp.asarray(p) for p in planes), jnp.asarray(hi),
                     jnp.asarray(lo), valid=jnp.asarray(valid),
                     stash=None if stash is None else jnp.asarray(stash),
                     **kw, **_ref_kw(interpret))
    pp = [t32(p) for p in planes]
    ps = None if stash is None else t32(stash)
    out = insert_bulk_adaptive(*pp, t32(hi), t32(lo),
                               valid=torch.from_numpy(valid), stash=ps, **kw)
    assert all(a is b for a, b in zip(out, pp))           # in place
    _same(out, ref)
    return ([u32(p) for p in pp], None if ps is None else u32(ps),
            out[-1].numpy())


def _probe_both(planes, stash, keys, *, nb, block, fp_bits, interpret=False):
    hi, lo = split(keys)
    ref = ref_probe(jnp.asarray(planes[0]), jnp.asarray(planes[1]),
                    jnp.asarray(hi), jnp.asarray(lo), fp_bits=fp_bits,
                    n_buckets=nb, block=block,
                    stash=None if stash is None else jnp.asarray(stash),
                    **_ref_kw(interpret))
    got = probe_adaptive(t32(planes[0]), t32(planes[1]), t32(hi), t32(lo),
                         fp_bits=fp_bits, n_buckets=nb, block=block,
                         stash=None if stash is None else t32(stash))
    _same([got], [ref])
    return got.numpy()


def _delete_both(planes, keys, valid, *, nb, block, fp_bits,
                 interpret=False):
    hi, lo = split(keys)
    ref = ref_delete(*(jnp.asarray(p) for p in planes), jnp.asarray(hi),
                     jnp.asarray(lo), valid=jnp.asarray(valid),
                     fp_bits=fp_bits, n_buckets=nb, block=block,
                     **_ref_kw(interpret))
    pp = [t32(p) for p in planes]
    out = delete_bulk_adaptive(*pp, t32(hi), t32(lo),
                               valid=torch.from_numpy(valid),
                               fp_bits=fp_bits, n_buckets=nb, block=block)
    _same(out, ref)
    return [u32(p) for p in pp], out[-1].numpy()


# (block, evict_rounds, stash slots, schedule, active / buffer buckets,
#  starting load, selector share, new keys, what the case must reach): the
#  new keys push the load to ~0.95 or past it, so chains kick adapted
#  slots (their selectors reset), spill and roll back.
CASES = {
    "b128-r8-stash": (128, 8, 16, False, 200, 256, 0.63, 0.3, 256,
                      {"kick", "spill"}),
    "b256-r32-overload": (256, 32, 0, False, 256, 256, 0.55, 0.25, 512,
                          {"kick", "rollback"}),
    "b128-r0-stash": (128, 0, 16, False, 250, 256, 0.8, 0.25, 256,
                      {"spill", "rollback"}),
    "b256-r8-schedule": (256, 8, 0, True, 500, 512, 0.45, 0.25, 1024,
                         {"kick", "rollback"}),
    "b128-r32-stash-full": (128, 32, 16, False, 120, 128, 0.9, 0.5, 256,
                            {"kick", "spill", "rollback"}),
}


def _sel0_slots(planes):
    """Occupied slots on selector 0."""
    shifts = 2 * np.arange(planes[0].shape[1], dtype=np.uint32)
    sel = (planes[1] >> shifts) & 3
    return int(((planes[0] != 0) & (sel == 0)).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_reference(case):
    (block, rounds, slots, schedule, nb, buf, load, share, n_new,
     must) = CASES[case]
    fp_bits = 12
    rng = np.random.RandomState(sorted(CASES).index(case))
    *planes, members = adaptive_planes(rng, nb, buf, load, fp_bits=fp_bits,
                                       sel_share=share)
    assert planes[1].any(), "the case needs nonzero selectors"
    stash = np.zeros((2, slots), np.uint32) if slots else None
    new = random_keys(rng, n_new)
    valid = rng.rand(n_new) < 0.97
    adapted_before = int((planes[0] != 0).sum() - _sel0_slots(planes))
    planes, stash, ok = _insert_both(planes, stash, new, valid, nb=nb,
                                     block=block, rounds=rounds,
                                     fp_bits=fp_bits, schedule=schedule)
    assert (planes[0][nb:] == 0).all(), "wrote past the active region"
    reached = set()
    if int((planes[0] != 0).sum() - _sel0_slots(planes)) < adapted_before:
        reached.add("kick")               # kicks reset adapted selectors
    if slots and (stash[0] != 0).any():
        reached.add("spill")
    if not ok[valid].all():
        reached.add("rollback")
    assert must <= reached, (must, reached)
    landed = new[ok]
    probes = np.concatenate([members[:128], landed[:64], random_keys(rng,
                                                                      64)])
    hit = _probe_both(planes, stash, probes, nb=nb, block=128,
                      fp_bits=fp_bits)
    in_table = _probe_both(planes, None, probes, nb=nb, block=128,
                           fp_bits=fp_bits)
    assert hit[:128].all() and (hit | ~in_table).all()
    gone = np.concatenate([members[:96], landed[:32], members[:32],
                           landed[:32], random_keys(rng, 64)])
    d_valid = rng.rand(gone.size) < 0.95
    _planes, d_ok = _delete_both(planes, gone, d_valid, nb=nb, block=block,
                                 fp_bits=fp_bits)
    assert d_ok[:96][d_valid[:96] & in_table[:96]].all()


def _adapted_slots(planes):
    return int((planes[0] != 0).sum()) - _sel0_slots(planes)


@pytest.mark.parametrize("label", list(ADAPTIVE_STAGING_CASES))
def test_staging_cases_match_reference(label):
    """ADAPTIVE_STAGING_CASES (the shapes that stress the kernels' staged
    rows, over four planes with adapted and scrambled slots): insert, then
    delete with repeats and residents, plain versions against the
    reference, bit for bit (all four planes, the stash, the ok masks)."""
    c = adaptive_staging_inputs(label)
    kw = dict(nb=c["n_buckets"], block=c["block"], fp_bits=16)
    before = _adapted_slots(c["planes"])
    assert before > 0, "the case needs nonzero selectors"
    planes, stash, ok = _insert_both(c["planes"], c["stash"], c["keys"],
                                     c["valid"], rounds=c["rounds"], **kw)
    assert not ok[c["valid"]].all(), "no insert failed"
    after = _adapted_slots(planes)
    planes, d_ok = _delete_both(planes, c["delete"], c["delete_valid"], **kw)
    assert d_ok.any() and not d_ok.all()
    if label == "tiny-rollback":
        # Without a stash every failed chain rolls back and every adapted
        # slot it kicked comes back; a stash that takes every failed chain
        # keeps the same kicks, and they reset adapted selectors.
        assert after == before
        ports = [t32(p) for p in c["planes"]]
        big = torch.zeros((2, 1024), dtype=torch.int32)
        hi, lo = split(c["keys"])
        insert_bulk_adaptive(*ports, t32(hi), t32(lo), fp_bits=16,
                             n_buckets=kw["nb"],
                             valid=torch.from_numpy(c["valid"]),
                             evict_rounds=c["rounds"], stash=big,
                             block=kw["block"])
        assert _adapted_slots([u32(p) for p in ports]) < before


def test_family_matches_reference_and_static_hash():
    rng = np.random.RandomState(7)
    hi, lo = split(random_keys(rng, 512))
    fam, i1, i2 = fingerprint_hash_family(t32(hi), t32(lo), fp_bits=12,
                                          n_buckets=1000, block=256)
    for kw in (dict(emulate=True), dict(interpret=True)):
        r_fam, r_i1, r_i2 = ref_family(jnp.asarray(hi), jnp.asarray(lo),
                                       fp_bits=12, n_buckets=1000, block=256,
                                       **kw)
        _same([*fam, i1, i2], [*r_fam, r_i1, r_i2])
    fp, s_i1, s_i2 = fingerprint_hash(t32(hi), t32(lo), fp_bits=12,
                                      n_buckets=1000)
    for a, b in ((fam[0], fp), (i1, s_i1), (i2, s_i2)):
        assert torch.equal(a, b)
    padded = ops.hash_family(t32(hi[:300]), t32(lo[:300]), fp_bits=12,
                             n_buckets=1000)
    _same([*padded[0], *padded[1:]], [f[:300] for f in (*fam, i1, i2)])


def test_tiny_cases_match_pallas_interpreter():
    rng = np.random.RandomState(8)
    nb, fp_bits = 30, 12
    *planes, members = adaptive_planes(rng, nb, 32, 0.6, fp_bits=fp_bits,
                                       sel_share=0.4)
    stash = np.zeros((2, 8), np.uint32)
    new = random_keys(rng, 64)
    planes, stash, ok = _insert_both(planes, stash, new, np.ones(64, bool),
                                     nb=nb, block=64, rounds=4,
                                     fp_bits=fp_bits, interpret=True)
    assert not ok.all() and (stash[0] != 0).any()
    probes = np.concatenate([members[:32], random_keys(rng, 32)])
    _probe_both(planes, stash, probes, nb=nb, block=64, fp_bits=fp_bits,
                interpret=True)
    _delete_both(planes, probes, np.ones(64, bool), nb=nb, block=64,
                 fp_bits=fp_bits, interpret=True)


def test_zero_selector_plane_equals_static_path():
    rng = np.random.RandomState(9)
    nb, buf = 250, 256
    keys = random_keys(rng, 1024)
    hi, lo = t32(split(keys)[0]), t32(split(keys)[1])
    table = torch.zeros((buf, 4), dtype=torch.int32)
    planes = [table.clone(), torch.zeros((buf, 1), dtype=torch.int32),
              table.clone(), table.clone()]
    stash_a, stash_s = (torch.zeros((2, 16), dtype=torch.int32)
                        for _ in range(2))
    kw = dict(fp_bits=12, n_buckets=nb, evict_rounds=16, block=128)
    ok_a = insert_bulk_adaptive(*planes, hi, lo, stash=stash_a, **kw)[-1]
    ok_s = insert_bulk(table, hi, lo, stash=stash_s, **kw)[-1]
    assert torch.equal(planes[0], table) and torch.equal(ok_a, ok_s)
    assert torch.equal(stash_a, stash_s) and not ok_s.all()
    assert not planes[1].any(), "insert must write selector 0"
    hit_a = probe_adaptive(planes[0], planes[1], hi, lo, fp_bits=12,
                           n_buckets=nb, stash=stash_a)
    assert torch.equal(hit_a, probe(table, hi, lo, fp_bits=12, n_buckets=nb,
                                    stash=stash_s))
    d_a = delete_bulk_adaptive(*planes, hi[:512], lo[:512], fp_bits=12,
                               n_buckets=nb, block=128)[-1]
    d_s = delete_bulk(table, hi[:512], lo[:512], fp_bits=12, n_buckets=nb,
                      block=128)[-1]
    assert torch.equal(planes[0], table) and torch.equal(d_a, d_s)
    assert not planes[2][table == 0].any(), "a cleared slot kept its key"


def _port_planes(state):
    return [u32(p) for p in state]


def test_single_lane_calls_match_oracle():
    """One key per call makes the block schedule the oracle's sequential
    one: inserts through spills and rollback, reports, then deletes
    through table and stash, all four planes and the stash after each
    phase."""
    nb, rounds, slots, fp_bits = 64, 8, 16, 12
    rng = np.random.RandomState(10)
    oracle = PyAdaptiveFilter(n_buckets=nb, bucket_size=4, fp_bits=fp_bits,
                              evict_rounds=rounds, stash_slots=slots)
    planes = [torch.zeros((nb, 4), dtype=torch.int32),
              torch.zeros((nb, 1), dtype=torch.int32),
              torch.zeros((nb, 4), dtype=torch.int32),
              torch.zeros((nb, 4), dtype=torch.int32)]
    stash = torch.zeros((2, slots), dtype=torch.int32)

    def check():
        got = _port_planes(planes)
        np.testing.assert_array_equal(got[0], oracle.table)
        np.testing.assert_array_equal(got[1], oracle.sel_plane_array())
        okhi, oklo = oracle.key_planes()
        np.testing.assert_array_equal(got[2], okhi)
        np.testing.assert_array_equal(got[3], oklo)
        np.testing.assert_array_equal(u32(stash), oracle.stash_array())

    keys = random_keys(rng, 280)
    ok_port = []
    for k in keys:
        hi, lo = (t32(x) for x in split(np.array([k], np.uint64)))
        ok = insert_bulk_adaptive(*planes, hi, lo, fp_bits=fp_bits,
                                  n_buckets=nb, evict_rounds=rounds,
                                  stash=stash, block=1)[-1]
        ok_port.append(bool(ok[0]))
        assert ok_port[-1] == oracle.insert(int(k))
    check()
    assert oracle.spills == slots and not all(ok_port)
    members = keys[np.array(ok_port)]
    probes = np.setdiff1d(random_keys(rng, 3000), keys)
    n_adapted = 0
    for k in np.concatenate([probes, members[:5]]):
        if not oracle.lookup(int(k)):
            continue
        hi, lo = (t32(x) for x in split(np.array([k], np.uint64)))
        _t, _s, adapted, resident = ops.adaptive_report(
            *planes, hi, lo, fp_bits=fp_bits, n_buckets=nb, donate=True)
        assert (bool(adapted[0]), bool(resident[0])) == \
            oracle.report_false_positive(int(k))
        n_adapted += bool(adapted[0])
    check()
    assert n_adapted > 0 and planes[1].any()
    for k in members[: members.size // 2]:
        hi, lo = (t32(x) for x in split(np.array([k], np.uint64)))
        out = ops.adaptive_delete(*planes, hi, lo, fp_bits=fp_bits,
                                  n_buckets=nb, stash=stash, donate=True)
        assert bool(out[-1][0]) == oracle.delete(int(k))
    check()
