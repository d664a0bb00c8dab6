"""Shared kernel math of the port (scheduling, rank, stash, chunking, the
copied keystore and policy) against the reference, bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunking as ref_chunking
from repro.core import keystore as ref_keystore
from repro.core import policy as ref_policy
from repro.core import scheduling as ref_sched
from repro.kernels import rank as ref_rank
from repro.kernels import stash as ref_stash
from repro_torch.core import chunking, keystore, policy, scheduling
from repro_torch.kernels import rank, stash

from torch_port_util import random_keys, split, t32, u32

pytestmark = pytest.mark.tier1


@pytest.mark.parametrize("n_buckets,n", [(7, 512), (64, 1000), (1000, 4096)])
def test_conflict_waves_and_dispatch_order(n_buckets, n):
    rng = np.random.RandomState(n_buckets)
    hi, lo = split(random_keys(rng, n))
    valid = rng.rand(n) < 0.9
    perm, inv = ref_sched.dispatch_order(jnp.asarray(hi), jnp.asarray(lo),
                                         jnp.asarray(valid),
                                         n_buckets=n_buckets)
    p_perm, p_inv = scheduling.dispatch_order(
        t32(hi), t32(lo), torch.from_numpy(valid), n_buckets=n_buckets)
    np.testing.assert_array_equal(p_perm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(p_inv.numpy(), np.asarray(inv))
    bucket = rng.randint(0, n_buckets, size=n).astype(np.int32)
    want = ref_sched.conflict_waves(jnp.asarray(bucket), jnp.asarray(valid))
    got = scheduling.conflict_waves(torch.from_numpy(bucket),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stable_sort_keeps_lane_order_on_ties():
    bucket = torch.tensor([3, 1, 3, 1, 3, 0, 1])
    valid = torch.ones(7, dtype=torch.bool)
    assert scheduling.conflict_waves(bucket, valid).tolist() == \
        [0, 0, 1, 1, 2, 0, 2]
    perm, inv = scheduling.dispatch_order_from_buckets(bucket, valid)
    # wave 0: buckets 0, 1, 3 in bucket order, each its earliest lane
    assert perm.tolist() == [5, 1, 0, 3, 2, 6, 4]
    assert (perm[inv] == torch.arange(7)).all()


def test_dedupe_keys():
    keys = np.array([5, 3, 5, 9, 3], np.uint64)
    uniq, inv = scheduling.dedupe_keys(keys)
    r_uniq, r_inv = ref_sched.dedupe_keys(keys)
    np.testing.assert_array_equal(uniq, r_uniq)
    np.testing.assert_array_equal(inv, r_inv)
    same, none = scheduling.dedupe_keys(np.array([1, 2], np.uint64))
    assert none is None and same.tolist() == [1, 2]


@pytest.mark.parametrize("with_fp", [False, True])
def test_rank_among_earlier(with_fp):
    rng = np.random.RandomState(5)
    target = rng.randint(0, 9, size=256).astype(np.int32)
    active = rng.rand(256) < 0.8
    fp = rng.randint(1, 4, size=256).astype(np.int32)
    want = ref_rank.rank_among_earlier(jnp.asarray(target),
                                       jnp.asarray(active),
                                       jnp.asarray(fp) if with_fp else None)
    got = rank.rank_among_earlier(torch.from_numpy(target),
                                  torch.from_numpy(active),
                                  torch.from_numpy(fp) if with_fp else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stash_match_spill_and_refs():
    rng = np.random.RandomState(6)
    n, slots, nb = 300, 64, 777
    hi, lo = split(random_keys(rng, n))
    r_st = ref_stash.make_stash(slots)
    p_st = stash.make_stash(slots, device="cpu")
    assert p_st.dtype == torch.int32 and p_st.shape == (2, slots)
    # pre-occupy some slots so spills skip them
    pre = np.zeros((2, slots), np.uint32)
    pre[0, ::5] = 77
    pre[1, ::5] = 3
    r_st, p_st = jnp.asarray(pre), t32(pre)
    want = rng.rand(n) < 0.3
    r_st, r_ok = ref_stash.stash_spill_ref(r_st, jnp.asarray(hi),
                                           jnp.asarray(lo), jnp.asarray(want),
                                           fp_bits=16, n_buckets=nb)
    p_ok = stash.stash_spill_ref(p_st, t32(hi), t32(lo),
                                 torch.from_numpy(want), fp_bits=16,
                                 n_buckets=nb)
    np.testing.assert_array_equal(p_ok.numpy(), np.asarray(r_ok))
    np.testing.assert_array_equal(u32(p_st), np.asarray(r_st))
    assert int(stash.stash_occupancy(p_st)) == \
        int(ref_stash.stash_occupancy(r_st)) == slots
    assert not p_ok.all()            # the stash filled up: later lanes miss
    probe_hi, probe_lo = split(np.concatenate(
        [random_keys(rng, 100), (hi.astype(np.uint64) << np.uint64(32))
         | lo.astype(np.uint64)]))
    got = stash.stash_probe_ref(p_st, t32(probe_hi), t32(probe_lo),
                                fp_bits=16, n_buckets=nb)
    ref_hit = ref_stash.stash_probe_ref(r_st, jnp.asarray(probe_hi),
                                        jnp.asarray(probe_lo), fp_bits=16,
                                        n_buckets=nb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_hit))
    assert got[100:][torch.from_numpy(np.array(r_ok))].all()
    with pytest.raises(ValueError):
        stash.make_stash(0, device="cpu")


def test_chunking_contract():
    assert chunking.CHUNK == ref_chunking.CHUNK == 4096
    for n in (1, 5, 4096, 4097):
        assert chunking.pow2_at_least(n) == ref_chunking.pow2_at_least(n)
    keys = random_keys(np.random.RandomState(7), 9000)
    ref_parts = list(ref_chunking.key_chunks(keys))
    parts = list(chunking.key_chunks(keys, device="cpu"))
    assert len(parts) == len(ref_parts) == 3
    for (h, l, v, n), (rh, rl, rv, rn) in zip(parts, ref_parts):
        assert n == rn and h.shape == (4096,)
        np.testing.assert_array_equal(u32(h), np.asarray(rh))
        np.testing.assert_array_equal(u32(l), np.asarray(rl))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    look = list(chunking.key_chunks(keys, with_valid=False, device="cpu"))
    assert all(v is None for _h, _l, v, _n in look)
    assert list(chunking.key_chunks(np.zeros(0, np.uint64), device="cpu")) == []
    out = chunking.collect_chunk_results(
        [torch.ones(4096, dtype=torch.bool), torch.zeros(4096, dtype=torch.bool)],
        [4096, 5])
    assert out.shape == (4101,) and out[:4096].all() and not out[4096:].any()
    assert chunking.collect_chunk_results([], []).shape == (0,)


def test_copied_keystore_matches():
    rng = np.random.RandomState(8)
    a, b = keystore.VectorKeystore(), ref_keystore.VectorKeystore()
    keys = rng.randint(0, 50, size=400).astype(np.uint64)
    for part in np.array_split(keys, 4):
        a.add(part)
        b.add(part)
    dele = rng.randint(0, 60, size=300).astype(np.uint64)
    np.testing.assert_array_equal(a.remove(dele), b.remove(dele))
    np.testing.assert_array_equal(a.materialize(), b.materialize())
    assert a.total == b.total and a.unique == b.unique
    np.testing.assert_array_equal(a.contains_batch(dele),
                                  b.contains_batch(dele))


@pytest.mark.parametrize("mode", ["PRE", "EOF"])
def test_copied_policy_matches(mode):
    mk = {"PRE": (policy.PrePolicy, ref_policy.PrePolicy),
          "EOF": (policy.EofPolicy, ref_policy.EofPolicy)}[mode]
    # same inputs, same decisions and same policy state
    a, b = mk[0](), mk[1]()
    cap_a = cap_b = 4096
    for items in np.random.RandomState(10).randint(0, 8000, size=300):
        da = a.observe(items=int(items), capacity=cap_a, ops=3)
        db = b.observe(items=int(items), capacity=cap_b, ops=3)
        assert (da is None) == (db is None)
        if da is not None:
            assert dataclasses.asdict(da) == dataclasses.asdict(db)
            cap_a, cap_b = da.new_capacity, db.new_capacity
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
