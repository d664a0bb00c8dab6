"""Kernels 1 and 2 (fingerprint_hash, probe): the port's plain versions
against the reference's XLA grid emulation (and, on small cases, its
Pallas interpreter), bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.fingerprint import fingerprint_hash as ref_fingerprint
from repro.kernels.insert import insert_bulk as ref_insert
from repro.kernels.probe import probe as ref_probe
from repro.kernels.probe import probe_emulated_tm
from repro_torch.core import hashing
from repro_torch.kernels import cuda, ops
from repro_torch.kernels.fingerprint import fingerprint_hash
from repro_torch.kernels.probe import probe, probe_plain, probe_tm
from repro_torch.kernels.staging_cases import (FINGERPRINT_CASES,
                                               PROBE_CASES, probe_inputs)

from torch_port_util import random_keys, split, t32, u32

pytestmark = pytest.mark.tier1


@pytest.mark.parametrize("fp_bits", [8, 16, 24])
@pytest.mark.parametrize("n_buckets", [777, 1024, 65521])
def test_fingerprint_hash_matches_emulation(fp_bits, n_buckets):
    hi, lo = split(random_keys(np.random.RandomState(n_buckets), 4096))
    want = ref_fingerprint(jnp.asarray(hi), jnp.asarray(lo), fp_bits=fp_bits,
                           n_buckets=n_buckets, block=1024, emulate=True)
    got = fingerprint_hash(t32(hi), t32(lo), fp_bits=fp_bits,
                           n_buckets=n_buckets, block=1024)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(u32(g), np.asarray(w))


def test_fingerprint_hash_matches_interpreter():
    hi, lo = split(random_keys(np.random.RandomState(1), 256))
    want = ref_fingerprint(jnp.asarray(hi), jnp.asarray(lo), fp_bits=16,
                           n_buckets=999, block=128, interpret=True)
    got = fingerprint_hash(t32(hi), t32(lo), fp_bits=16, n_buckets=999,
                           block=128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g), np.asarray(w))


@pytest.mark.parametrize("n,offset", FINGERPRINT_CASES)
def test_fingerprint_hash_cases_match_emulation(n, offset):
    """FINGERPRINT_CASES: sizes 1, 3, 4097, 2^17 + 5 and 2^19 + 5, and key
    views that start one element into their storage, which no 16-byte
    access may read."""
    hi, lo = split(random_keys(np.random.RandomState(n + offset),
                               n + offset))
    thi, tlo = t32(hi)[offset:], t32(lo)[offset:]
    assert (thi.data_ptr() % 16 == 0) == (offset == 0)
    nb = 1_000_003 - n
    want = ref_fingerprint(jnp.asarray(hi[offset:]), jnp.asarray(lo[offset:]),
                           fp_bits=16, n_buckets=nb, block=n, emulate=True)
    got = fingerprint_hash(thi, tlo, fp_bits=16, n_buckets=nb, block=n)
    for g, w in zip(got, want):
        assert g.shape == (n,)
        np.testing.assert_array_equal(u32(g), np.asarray(w))


@pytest.mark.parametrize("label", list(PROBE_CASES))
def test_probe_cases_match_reference(label):
    """PROBE_CASES (full stashes, a key's fingerprint at a third bucket,
    32-bit fingerprints of one 16-bit fold, 8-bit ones that fill the
    prefilter's map, stashes of 1 and 1025 slots, bucket sizes 1 and 8,
    N = 1, 4097 and 20000, padding lanes), with and without their stash:
    the plain version against the reference's probe in emulation for every
    lane, and probe_tm (its plain version here) against the reference's
    probe_emulated_tm over the counted keys."""
    c = probe_inputs(label, 0)
    hi, lo = split(c["keys"])
    k = c["counted"]
    kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"])
    for stash in (None, c["stash"]):
        rst = None if stash is None else jnp.asarray(stash)
        tst = None if stash is None else t32(stash)
        want = ref_probe(jnp.asarray(c["table"]), jnp.asarray(hi),
                         jnp.asarray(lo), stash=rst, block=c["block"],
                         emulate=True, **kw)
        got = probe_plain(t32(c["table"]), t32(hi), t32(lo), stash=tst, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        hit, plane = probe_tm(t32(c["table"]), t32(hi), t32(lo), stash=tst,
                              n_valid=k, block=c["block"], **kw)
        rhit, rdepth = probe_emulated_tm(
            jnp.asarray(c["table"]), jnp.asarray(hi[:k]), jnp.asarray(lo[:k]),
            c["n_buckets"], rst, fp_bits=c["fp_bits"])
        np.testing.assert_array_equal(hit.numpy(), got.numpy())
        np.testing.assert_array_equal(hit[:k].numpy(), np.asarray(rhit))
        np.testing.assert_array_equal(plane.numpy(),
                                      np.asarray(rdepth).astype(np.int64))
    if c["stash"] is None:
        return
    # What a case stresses is in its data: entries that hold a missing
    # key's fingerprint at a bucket of another key, or a fingerprint of its
    # fold that is not its own.
    fp = hashing.fingerprint_np(hi, lo, c["fp_bits"])
    live = c["stash"][0][c["stash"][0] != 0]
    missed = ~got.numpy()
    if label == "same-fp-other-bucket":
        assert (missed & np.isin(fp, live)).any()
    if label == "fp32-folds":
        def fold(x):
            return (x ^ (x >> 16)) & 0xFFFF
        assert (missed & np.isin(fold(fp), fold(live))
                & ~np.isin(fp, live)).any()


def _filled(seed, buf, n_buckets, n_keys, stash_slots=0):
    """A reference table (and stash) filled by the reference's insert."""
    rng = np.random.RandomState(seed)
    keys = random_keys(rng, n_keys)
    hi, lo = split(keys)
    stash = (jnp.zeros((2, stash_slots), jnp.uint32) if stash_slots
             else None)
    out = ref_insert(jnp.zeros((buf, 4), jnp.uint32), jnp.asarray(hi),
                     jnp.asarray(lo), fp_bits=16, n_buckets=n_buckets,
                     evict_rounds=4, stash=stash, block=128, emulate=True)
    table = np.asarray(out[0])
    stash = np.asarray(out[1]) if stash_slots else None
    probe_keys = np.concatenate([keys, random_keys(rng, n_keys)])
    return table, stash, probe_keys


@pytest.mark.parametrize("stash_slots", [0, 64])
@pytest.mark.parametrize("buf,n_buckets", [(1024, 1024), (1024, 700)])
def test_probe_matches_emulation(stash_slots, buf, n_buckets):
    table, stash, keys = _filled(2, buf, n_buckets, 3200, stash_slots)
    if stash_slots:
        assert (stash[0] != 0).any()       # some keys live in the stash
    hi, lo = split(keys)
    want = ref_probe(jnp.asarray(table), jnp.asarray(hi), jnp.asarray(lo),
                     fp_bits=16, n_buckets=n_buckets,
                     stash=None if stash is None else jnp.asarray(stash),
                     block=128, emulate=True)
    got = probe(t32(table), t32(hi), t32(lo), fp_bits=16,
                n_buckets=n_buckets,
                stash=None if stash is None else t32(stash), block=128)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:3200].sum() > 2500


def test_probe_matches_interpreter_with_stash():
    table, stash, keys = _filled(3, 128, 100, 512, 16)
    hi, lo = split(keys[:256])
    want = ref_probe(jnp.asarray(table), jnp.asarray(hi), jnp.asarray(lo),
                     fp_bits=16, n_buckets=100, stash=jnp.asarray(stash),
                     block=128, interpret=True)
    got = probe(t32(table), t32(hi), t32(lo), fp_bits=16, n_buckets=100,
                stash=t32(stash), block=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 1000, 5000])
def test_padded_dispatch_matches(n):
    table, stash, keys = _filled(4, 2048, 1500, 4096, 32)
    hi, lo = split(keys[:n])
    want = ref_ops.probe_dispatch(jnp.asarray(table), jnp.asarray(hi),
                                  jnp.asarray(lo), fp_bits=16,
                                  n_buckets=1500, stash=jnp.asarray(stash))
    got = ops.probe_dispatch(t32(table), t32(hi), t32(lo), fp_bits=16,
                             n_buckets=1500, stash=t32(stash))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rf = ref_ops.hash_keys(jnp.asarray(hi), jnp.asarray(lo), fp_bits=16,
                           n_buckets=1500, use_pallas="always")
    pf = ops.hash_keys(t32(hi), t32(lo), fp_bits=16, n_buckets=1500)
    for g, w in zip(pf, rf):
        assert g.shape == (n,)
        np.testing.assert_array_equal(u32(g), np.asarray(w))


def test_empty_batches_and_block_check():
    table = torch.zeros((64, 4), dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    assert ops.probe_dispatch(table, empty, empty, fp_bits=16).shape == (0,)
    assert all(x.shape == (0,) for x in
               ops.hash_keys(empty, empty, fp_bits=16, n_buckets=64))
    keys = torch.zeros(1000, dtype=torch.int32)
    with pytest.raises(ValueError):
        probe(table, keys, keys, fp_bits=16, block=128)
    with pytest.raises(ValueError):
        fingerprint_hash(keys, keys, fp_bits=16, n_buckets=64, block=128)


def test_cpu_tensors_take_the_plain_version():
    cuda.reset_counts()
    hi, lo = split(random_keys(np.random.RandomState(5), 256))
    fingerprint_hash(t32(hi), t32(lo), fp_bits=16, n_buckets=64)
    probe(torch.zeros((64, 4), dtype=torch.int32), t32(hi), t32(lo),
          fp_bits=16)
    assert cuda.PLAIN_CALLS["fingerprint_hash"] == 1
    assert cuda.PLAIN_CALLS["probe"] == 1
    assert sum(cuda.LAUNCHES.values()) == 0
