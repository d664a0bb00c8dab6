"""The scan backend (``FilterOps(backend="torch")``) and its helpers against
the reference's ``FilterOps(backend="jnp")`` and ``core/filter.py``, bit for
bit: tables, counts, stashes and ok masks.  Also the scan walks on their
own (``kernels/scan.py``) against the reference's scans, the elastic
migration's ``insert_pairs``, the new hashing helpers, ``wave_count`` and
the filter refs of ``kernels/ref.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filter as jfilter
from repro.core import hashing as jhash
from repro.core import scheduling as jsched
from repro.core.filter_ops import FilterOps as RefOps
from repro.distributed import elastic as jelastic
from repro.kernels import ref as jref
from repro_torch.convert import state_from_numpy
from repro_torch.core import filter as tfilter
from repro_torch.core import hashing
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.scheduling import wave_count
from repro_torch.distributed.elastic import insert_pairs
from repro_torch.kernels import cuda
from repro_torch.kernels import ref as tref
from repro_torch.kernels.scan import scan_delete, scan_insert
from repro_torch.kernels.staging_cases import SCAN_CASES, scan_inputs

from torch_port_util import random_keys, split, t32, u32

pytestmark = pytest.mark.tier1


def _states(n_buckets, buffer=None, table=None):
    buffer = buffer or n_buckets
    table = np.zeros((buffer, 4), np.uint32) if table is None else table
    ref = jfilter.FilterState(jnp.asarray(table), jnp.int32(0),
                              jnp.int32(n_buckets))
    port, _ = state_from_numpy(table, 0, n_buckets, device="cpu")
    return ref, port


def _same(ref_state, port_state, ref_ok, port_ok):
    np.testing.assert_array_equal(np.asarray(ref_state.table),
                                  u32(port_state.table))
    assert int(ref_state.count) == int(port_state.count)
    np.testing.assert_array_equal(np.asarray(ref_ok), port_ok.numpy())


# (active buckets, buffer, keys as a share of active slots, max_disp)
STREAMS = {"load-0.9": (256, 256, 0.9, 500),
           "full-failures": (256, 256, 1.0, 500),
           "short-chains": (256, 256, 0.95, 8),
           "active-below-buffer": (200, 256, 0.96, 32)}


@pytest.mark.parametrize("label", list(STREAMS))
def test_insert_lookup_delete_rebuild_match_jnp(label):
    nb, buf, share, max_disp = STREAMS[label]
    rng = np.random.RandomState(len(label))
    keys = random_keys(rng, int(nb * 4 * share))
    hi, lo = split(keys)
    jh, jl, th, tl = jnp.asarray(hi), jnp.asarray(lo), t32(hi), t32(lo)
    ref_ops = RefOps(backend="jnp", max_disp=max_disp)
    ops = FilterOps(backend="torch", max_disp=max_disp)
    rs, ps = _states(nb, buf)
    half = keys.size // 2
    for sl in (slice(0, half), slice(half, None)):
        rs, rok = ref_ops.insert(rs, jh[sl], jl[sl])
        ps, pok = ops.insert(ps, th[sl], tl[sl])
        _same(rs, ps, rok, pok)
    if "failures" in label or "short" in label:
        assert not pok.all(), "the stream must exhaust some chains"
    absent_hi, absent_lo = split(random_keys(rng, 2000))
    for h, l in ((hi, lo), (absent_hi, absent_lo)):
        np.testing.assert_array_equal(
            np.asarray(ref_ops.lookup(rs, jnp.asarray(h), jnp.asarray(l))),
            ops.lookup(ps, t32(h), t32(l)).numpy())
    # deletes with duplicates: acknowledged keys, some twice over
    placed = np.nonzero(pok.numpy())[0]
    dk = np.concatenate([keys[placed[:300]], keys[placed[:100]]])
    dh, dl = split(dk)
    rs, rok = ref_ops.delete(rs, jnp.asarray(dh), jnp.asarray(dl))
    ps, pok = ops.delete(ps, t32(dh), t32(dl))
    _same(rs, ps, rok, pok)
    rs, rok = ref_ops.rebuild(jh, jl, nb, 4, buffer_buckets=buf)
    ps, pok = ops.rebuild(th, tl, nb, 4, buffer_buckets=buf)
    _same(rs, ps, rok, pok)


def test_valid_mask_and_stash_ops_match_jnp():
    """insert_spill / lookup_with_stash / the raw-table ops with a stash,
    and a valid mask that leaves lanes untouched."""
    rng = np.random.RandomState(4)
    nb = 128
    keys = random_keys(rng, int(nb * 4 * 1.15))
    hi, lo = split(keys)
    valid = rng.rand(keys.size) < 0.9
    ref_ops = RefOps(backend="jnp", max_disp=16)
    ops = FilterOps(backend="torch", max_disp=16)
    rs, ps = _states(nb)
    rst, pst = jnp.zeros((2, 24), jnp.uint32), torch.zeros((2, 24),
                                                           dtype=torch.int32)
    rs, rst, rok = ref_ops.insert_spill(rs, rst, jnp.asarray(hi),
                                        jnp.asarray(lo),
                                        valid=jnp.asarray(valid))
    ps, pst2, pok = ops.insert_spill(ps, pst, t32(hi), t32(lo),
                                     valid=torch.from_numpy(valid))
    _same(rs, ps, rok, pok)
    np.testing.assert_array_equal(np.asarray(rst), u32(pst2))
    assert not pst.any(), "the caller's stash is left as it was"
    assert (u32(pst2)[0] != 0).sum() == 24 and not pok.numpy()[valid].all()
    np.testing.assert_array_equal(
        np.asarray(ref_ops.lookup_with_stash(rs, rst, jnp.asarray(hi),
                                             jnp.asarray(lo))),
        ops.lookup_with_stash(ps, pst2, t32(hi), t32(lo)).numpy())
    dh, dl = hi[rok], lo[rok]
    rt, rst2, rdok = ref_ops.delete_table(rs.table, jnp.asarray(dh),
                                          jnp.asarray(dl), n_buckets=nb,
                                          stash=rst)
    pt, pst3, pdok = ops.delete_table(ps.table, t32(dh), t32(dl),
                                      n_buckets=nb, stash=pst2)
    np.testing.assert_array_equal(np.asarray(rt), u32(pt))
    np.testing.assert_array_equal(np.asarray(rst2), u32(pst3))
    np.testing.assert_array_equal(np.asarray(rdok), pdok.numpy())
    assert pdok.all() and not pst3.any()
    # raw-table insert with and without a stash, and the raw probe
    rt, rok = ref_ops.insert_table(jnp.zeros((nb, 4), jnp.uint32),
                                   jnp.asarray(hi), jnp.asarray(lo))
    pt, pok = ops.insert_table(torch.zeros((nb, 4), dtype=torch.int32),
                               t32(hi), t32(lo))
    np.testing.assert_array_equal(np.asarray(rt), u32(pt))
    np.testing.assert_array_equal(np.asarray(rok), pok.numpy())
    np.testing.assert_array_equal(
        np.asarray(ref_ops.probe_table(rt, jnp.asarray(hi), jnp.asarray(lo))),
        ops.probe_table(pt, t32(hi), t32(lo)).numpy())


def test_scan_walks_match_reference_scans():
    """scan_insert in key mode is ``bulk_insert``; scan_delete is
    ``bulk_delete`` (home else alternate, key by key); a stack of shards is
    each shard walked on its own.  Every key-mode and delete case."""
    for label, case in SCAN_CASES.items():
        if case[0] not in ("key", "delete"):
            continue
        tables, _st, a, b, valid, kw = scan_inputs(label)
        fp_bits = kw["fp_bits"]
        tt = t32(tables)
        if kw["mode"] == "delete":
            ok = scan_delete(tt, t32(a), t32(b), fp_bits=fp_bits,
                             n_buckets=kw["n_buckets"],
                             valid=torch.from_numpy(valid))
        else:
            ok = scan_insert(tt, t32(a), t32(b), mode="key", fp_bits=fp_bits,
                             n_buckets=kw["n_buckets"],
                             max_disp=kw["max_disp"],
                             valid=torch.from_numpy(valid))
        for s in range(tables.shape[0]):
            st = jfilter.FilterState(jnp.asarray(tables[s]), jnp.int32(0),
                                     jnp.int32(kw["n_buckets"]))
            args = (st, jnp.asarray(a[s]), jnp.asarray(b[s]))
            if kw["mode"] == "delete":
                st, rok = jfilter.bulk_delete(*args, fp_bits=fp_bits,
                                              valid=jnp.asarray(valid[s]))
            else:
                st, rok = jfilter.bulk_insert(*args, fp_bits=fp_bits,
                                              max_disp=kw["max_disp"],
                                              valid=jnp.asarray(valid[s]))
            np.testing.assert_array_equal(np.asarray(st.table), u32(tt[s]),
                                          err_msg=label)
            np.testing.assert_array_equal(np.asarray(rok), ok[s].numpy(),
                                          err_msg=label)


@pytest.mark.parametrize("label", [k for k, v in SCAN_CASES.items()
                                   if v[0] == "pair"])
def test_insert_pairs_match_reference(label):
    """Migrated (bucket, fp) pairs with spills into a stash that fills:
    the port's ``insert_pairs`` against the reference's, shard by shard."""
    tables, stashes, a, b, valid, kw = scan_inputs(label)
    fn = jax.jit(jelastic.insert_pairs,
                 static_argnames=("n_buckets", "max_disp"))
    spilled = 0
    for s in range(tables.shape[0]):
        rt, rst, rok = fn(jnp.asarray(tables[s]), jnp.asarray(stashes[s]),
                          jnp.asarray(a[s]), jnp.asarray(b[s]),
                          jnp.asarray(valid[s]), n_buckets=kw["n_buckets"],
                          max_disp=kw["max_disp"])
        pt, pst, pok = insert_pairs(t32(tables[s]), t32(stashes[s]),
                                    t32(a[s]), t32(b[s]),
                                    torch.from_numpy(valid[s]),
                                    n_buckets=kw["n_buckets"],
                                    max_disp=kw["max_disp"])
        np.testing.assert_array_equal(np.asarray(rt), u32(pt))
        np.testing.assert_array_equal(np.asarray(rst), u32(pst))
        np.testing.assert_array_equal(np.asarray(rok), pok.numpy())
        spilled += int((u32(pst)[0] != 0).sum() - (stashes[s][0] != 0).sum())
    assert spilled > 0, "the case must spill"


def test_scan_plain_versions_count_their_calls():
    cuda.reset_counts()
    tables, _st, a, b, valid, kw = scan_inputs("delete-shards")
    scan_delete(t32(tables), t32(a), t32(b), fp_bits=16,
                n_buckets=kw["n_buckets"], valid=torch.from_numpy(valid))
    assert cuda.PLAIN_CALLS["scan_delete"] == 1 and not cuda.LAUNCHES
    with pytest.raises(ValueError):
        scan_insert(t32(tables), t32(a), t32(b), mode="bucket")
    with pytest.raises(ValueError):
        scan_insert(t32(tables), t32(a), t32(b), mode="key")


def test_scan_backend_membership_goes_through_probe_dispatch():
    """The scan backend's lookups are the probe kernel's (membership does
    not depend on the insert schedule): on the CPU each call counts one
    plain ``probe`` call, the count a card launch would add, and the
    answers equal the reference's ``bulk_lookup``."""
    rng = np.random.RandomState(5)
    nb = 256
    keys = random_keys(rng, nb * 3)
    hi, lo = split(keys)
    ops = FilterOps(backend="torch", max_disp=16)
    rs, ps = _states(nb)
    rs, _ = jfilter.bulk_insert_hybrid(rs, jnp.asarray(hi), jnp.asarray(lo),
                                       fp_bits=16, max_disp=16)
    ps, _ = ops.insert(ps, t32(hi), t32(lo))
    stash = torch.zeros((2, 8), dtype=torch.int32)
    probes = rng.randint(0, 2**31, size=(2, 2 * keys.size)).astype(np.uint32)
    qh, ql = (np.concatenate([h, p]) for h, p in zip((hi, lo), probes))
    want = np.asarray(jfilter.bulk_lookup(rs, jnp.asarray(qh),
                                          jnp.asarray(ql), fp_bits=16))
    cuda.reset_counts()
    got = [ops.lookup(ps, t32(qh), t32(ql)),
           ops.lookup_with_stash(ps, stash, t32(qh), t32(ql)),
           ops.probe_table(ps.table, t32(qh), t32(ql), n_buckets=nb,
                           stash=stash)]
    assert cuda.PLAIN_CALLS["probe"] == 3
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)


def test_owner_hashes_match_reference():
    rng = np.random.RandomState(3)
    hi = rng.randint(0, 2**32, 2048).astype(np.uint32)
    lo = rng.randint(0, 2**32, 2048).astype(np.uint32)
    b = rng.randint(0, 2**31, 2048).astype(np.uint32)
    fp = rng.randint(1, 2**16, 2048).astype(np.uint32)
    for nb in (64, 1000, 1 << 20):
        for n_shards in (1, 2, 4, 8):
            want = jhash.owner_shard_np(hi, lo, n_shards)
            np.testing.assert_array_equal(
                hashing.owner_shard_np(hi, lo, n_shards), want)
            np.testing.assert_array_equal(
                hashing.owner_shard(t32(hi), t32(lo), n_shards).numpy(), want)
            np.testing.assert_array_equal(np.asarray(jhash.owner_shard(
                jnp.asarray(hi), jnp.asarray(lo), n_shards)), want)
            want = jhash.owner_shard_pair_np(b, fp, nb, n_shards)
            np.testing.assert_array_equal(
                hashing.owner_shard_pair_np(b, fp, nb, n_shards), want)
            np.testing.assert_array_equal(hashing.owner_shard_pair(
                t32(b), t32(fp), nb, n_shards).numpy(), want)
            want = jhash.owner_shard_key_pair_np(hi, lo, nb, 16, n_shards)
            np.testing.assert_array_equal(
                hashing.owner_shard_key_pair_np(hi, lo, nb, 16, n_shards),
                want)
            np.testing.assert_array_equal(hashing.owner_shard_key_pair(
                t32(hi), t32(lo), nb, 16, n_shards).numpy(), want)
            np.testing.assert_array_equal(np.asarray(
                jhash.owner_shard_key_pair(jnp.asarray(hi), jnp.asarray(lo),
                                           nb, 16, n_shards)), want)


def test_owner_pair_invariance_and_hierarchy():
    """Either bucket of a pair gives its owner, and owner(2n) mod n ==
    owner(n) (the elastic invariants), on the port's hashes."""
    rng = np.random.RandomState(4)
    nb = 256
    b = t32(rng.randint(0, nb, 1024).astype(np.uint32))
    fp = t32(rng.randint(1, 2**16, 1024).astype(np.uint32))
    alt = hashing.alt_index(b, fp, nb)
    for n in (1, 2, 4, 8):
        o_n = hashing.owner_shard_pair(b, fp, nb, n)
        assert torch.equal(o_n, hashing.owner_shard_pair(alt, fp, nb, n))
        assert torch.equal(hashing.owner_shard_pair(b, fp, nb, 2 * n) % n,
                           o_n)


def test_dyn_spellings_and_wave_count_match_reference():
    rng = np.random.RandomState(5)
    hi, lo = split(random_keys(rng, 3000))
    fp = jhash.fingerprint_np(hi, lo, 16)
    for nb in (100, 4096):
        np.testing.assert_array_equal(
            hashing.index_hash_dyn(t32(hi), t32(lo), nb).numpy(),
            np.asarray(jhash.index_hash_dyn(jnp.asarray(hi), jnp.asarray(lo),
                                            jnp.int32(nb))))
        np.testing.assert_array_equal(
            hashing.alt_index_dyn(t32(hi), t32(fp), nb).numpy(),
            np.asarray(jhash.alt_index_dyn(jnp.asarray(hi), jnp.asarray(fp),
                                           jnp.int32(nb))))
        i1 = jhash.index_hash_np(hi, lo, nb).astype(np.int32)
        valid = rng.rand(hi.size) < 0.8
        for v in (valid, np.zeros_like(valid)):
            assert int(wave_count(torch.from_numpy(i1.astype(np.int64)),
                                  torch.from_numpy(v))) == int(
                jsched.wave_count(jnp.asarray(i1), jnp.asarray(v)))
    assert int(wave_count(torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.bool))) == 0


def test_filter_refs_match_reference():
    rng = np.random.RandomState(6)
    nb = 300
    table = np.zeros((512, 4), np.uint32)
    hi, lo = split(random_keys(rng, 1100))
    valid = rng.rand(hi.size) < 0.9
    jh, jl, th, tl = jnp.asarray(hi), jnp.asarray(lo), t32(hi), t32(lo)
    for r, p in zip(jref.fingerprint_ref(jh, jl, fp_bits=16, n_buckets=nb),
                    tref.fingerprint_ref(th, tl, fp_bits=16, n_buckets=nb)):
        np.testing.assert_array_equal(np.asarray(r), p.numpy())
    rt, rp = jref.insert_once_ref(jnp.asarray(table), jh, jl, fp_bits=16,
                                  n_buckets=nb, valid=jnp.asarray(valid))
    pt, pp = tref.insert_once_ref(t32(table), th, tl, fp_bits=16,
                                  n_buckets=nb, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(rt), u32(pt))
    np.testing.assert_array_equal(np.asarray(rp), pp.numpy())
    rest = valid & ~np.asarray(rp)
    rt, rok = jref.insert_residue_ref(rt, jh, jl, fp_bits=16, n_buckets=nb,
                                      valid=jnp.asarray(rest), max_disp=20)
    pt, pok = tref.insert_residue_ref(pt, th, tl, fp_bits=16, n_buckets=nb,
                                      valid=torch.from_numpy(rest),
                                      max_disp=20)
    np.testing.assert_array_equal(np.asarray(rt), u32(pt))
    np.testing.assert_array_equal(np.asarray(rok), pok.numpy())
    np.testing.assert_array_equal(
        np.asarray(jref.probe_ref(rt, jh, jl, fp_bits=16, n_buckets=nb)),
        tref.probe_ref(pt, th, tl, fp_bits=16, n_buckets=nb).numpy())
    rt, rd = jref.delete_ref(rt, jh[:500], jl[:500], fp_bits=16,
                             n_buckets=nb)
    pt, pd = tref.delete_ref(pt, th[:500], tl[:500], fp_bits=16,
                             n_buckets=nb)
    np.testing.assert_array_equal(np.asarray(rt), u32(pt))
    np.testing.assert_array_equal(np.asarray(rd), pd.numpy())


def test_scan_cases_cover_what_they_name():
    """The cases drive what the kernels find hard: failed chains at load
    0.97, a stash that fills, duplicates that miss."""
    assert set(SCAN_CASES) >= {"key-load-0.97", "pair-stash-16",
                               "delete-dups"}
    tables, _st, a, b, valid, kw = scan_inputs("key-load-0.97")
    tt = t32(tables)
    ok = scan_insert(tt, t32(a), t32(b), mode="key", fp_bits=16,
                     n_buckets=kw["n_buckets"], max_disp=kw["max_disp"])
    assert 0 < int((~ok).sum()) and (tt != 0).float().mean() >= 0.97
    tables, stashes, a, b, valid, kw = scan_inputs("pair-stash-16")
    st = t32(stashes)
    ok = scan_insert(t32(tables), t32(a), t32(b), mode="pair",
                     n_buckets=kw["n_buckets"], max_disp=kw["max_disp"],
                     valid=torch.from_numpy(valid), stashes=st)
    assert bool((st[:, 0] != 0).all()) and not bool(ok.all())
