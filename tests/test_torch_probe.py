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
from repro_torch.kernels import cuda, ops
from repro_torch.kernels.fingerprint import fingerprint_hash
from repro_torch.kernels.probe import probe

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
