"""Kernel 5 (probe_multi, the streaming ring's fused fan-out probe): the
port's plain version against the reference's XLA grid emulation (and, on
one small case, its Pallas interpreter), bit for bit, and the dispatch
around it (``filter_lookup_multi``, ``multi_prober``,
``FilterOps.fanout_prober``) against the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.filter_ops import FilterOps as RefFilterOps
from repro.kernels import ops as ref_ops
from repro.kernels.insert import insert_bulk as ref_insert
from repro.kernels.probe import probe_multi as ref_probe_multi
from repro_torch.core.filter_ops import FilterOps
from repro_torch.kernels import cuda, ops
from repro_torch.kernels.probe import probe_multi

from torch_port_util import random_keys, split, t32

pytestmark = pytest.mark.tier1


def _generations(seed, k, buf, n_buckets, n_keys, stash_slots, *,
                 evict_rounds=4):
    """K reference tables (and stashes) filled by the reference's insert
    to different loads -> (tables uint32[K, buf, 4], stashes or None,
    probe keys: every key whose insert landed, then as many absent
    ones)."""
    rng = np.random.RandomState(seed)
    tables, stashes, inserted = [], [], []
    for g in range(k):
        keys = random_keys(rng, n_keys * (g + 2) // (k + 1) // 128 * 128)
        hi, lo = split(keys)
        stash = (jnp.zeros((2, stash_slots), jnp.uint32) if stash_slots
                 else None)
        out = ref_insert(jnp.zeros((buf, 4), jnp.uint32), jnp.asarray(hi),
                         jnp.asarray(lo), fp_bits=16, n_buckets=n_buckets,
                         evict_rounds=evict_rounds, stash=stash, block=128,
                         emulate=True)
        tables.append(np.asarray(out[0]))
        stashes.append(np.asarray(out[1]) if stash_slots else None)
        inserted.append(keys[np.asarray(out[-1])])
    inserted = np.concatenate(inserted)
    probe_keys = np.concatenate([inserted, random_keys(rng, inserted.size)])
    probe_keys = probe_keys[: probe_keys.size // 128 * 128]
    return (np.stack(tables), np.stack(stashes) if stash_slots else None,
            probe_keys)


def _ref(tables, stashes, hi, lo, n_buckets, **kw):
    return np.asarray(ref_probe_multi(
        jnp.asarray(tables), jnp.asarray(hi), jnp.asarray(lo), fp_bits=16,
        n_buckets=n_buckets,
        stashes=None if stashes is None else jnp.asarray(stashes), **kw))


def _port(tables, stashes, hi, lo, n_buckets, **kw):
    return probe_multi(t32(tables), t32(hi), t32(lo), fp_bits=16,
                       n_buckets=n_buckets,
                       stashes=None if stashes is None else t32(stashes),
                       **kw)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("stash_slots", [0, 32])
@pytest.mark.parametrize("buf,n_buckets", [(1024, 1024), (1024, 700)])
def test_probe_multi_matches_emulation(k, stash_slots, buf, n_buckets):
    tables, stashes, keys = _generations(k, k, buf, n_buckets, 3200,
                                         stash_slots)
    if stash_slots and k > 1:
        assert (stashes[:, 0] != 0).any()   # some keys live in a stash
    hi, lo = split(keys)
    want = _ref(tables, stashes, hi, lo, n_buckets, block=128, emulate=True)
    got = _port(tables, stashes, hi, lo, n_buckets, block=128)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[: keys.size // 2].all()      # every landed key is found


@pytest.mark.parametrize("gens", [[0], [2, 0], [1, 2], []])
def test_probe_multi_live_slots_match_emulation(gens):
    """``gens`` (the ring's live pool slots) probes those generations of
    the K, as the reference does over the same generations stacked."""
    tables, stashes, keys = _generations(11, 3, 1024, 900, 3200, 32)
    hi, lo = split(keys)
    got = _port(tables, stashes, hi, lo, 900, gens=gens, block=128)
    if gens:
        want = _ref(tables[gens], stashes[gens], hi, lo, 900, block=128,
                    emulate=True)
    else:
        want = np.zeros(keys.size, bool)
    np.testing.assert_array_equal(got.numpy(), want)
    prober = FilterOps(fp_bits=16, backend="cuda").fanout_prober(
        t32(tables), t32(stashes), n_buckets=900, gens=gens)
    np.testing.assert_array_equal(prober(t32(hi), t32(lo)).numpy(), want)


def test_probe_multi_heavy_contention_matches_interpreter():
    """128x4 tables at heavy contention, two generations with stashes:
    the port against the Pallas interpreter itself."""
    tables, stashes, keys = _generations(7, 2, 128, 128, 1024, 64,
                                         evict_rounds=16)
    assert (stashes[:, 0] != 0).sum() > 10
    hi, lo = split(keys[:512])
    want = _ref(tables, stashes, hi, lo, 128, block=256, interpret=True)
    got = _port(tables, stashes, hi, lo, 128, block=256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), _ref(tables, stashes, hi, lo, 128, block=256,
                          emulate=True))


@pytest.mark.parametrize("n", [1, 1000, 5000])
def test_lookup_multi_and_prober_pad_the_tail(n):
    tables, stashes, keys = _generations(4, 2, 2048, 1500, 4096, 32)
    hi, lo = split(keys[:n])
    kw = dict(fp_bits=16, n_buckets=1500)
    want = np.asarray(ref_ops.filter_lookup_multi(
        jnp.asarray(tables), jnp.asarray(hi), jnp.asarray(lo),
        stashes=jnp.asarray(stashes), use_pallas="always", **kw))
    got = ops.filter_lookup_multi(t32(tables), t32(hi), t32(lo),
                                  stashes=t32(stashes), **kw)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    ref_prober = ref_ops.multi_prober(jnp.asarray(tables),
                                      stashes=jnp.asarray(stashes),
                                      use_pallas="always", **kw)
    prober = ops.multi_prober(t32(tables), stashes=t32(stashes), **kw)
    for m in (n, max(1, n // 3)):
        np.testing.assert_array_equal(
            prober(t32(hi[:m]), t32(lo[:m])).numpy(),
            np.asarray(ref_prober(jnp.asarray(hi[:m]), jnp.asarray(lo[:m]))))


def test_fanout_prober_matches_reference():
    tables, stashes, keys = _generations(5, 3, 512, 512, 1500, 16)
    hi, lo = split(keys[:4096])
    ref = RefFilterOps(fp_bits=16, backend="pallas").fanout_prober(
        jnp.asarray(tables), jnp.asarray(stashes), n_buckets=512)
    port = FilterOps(fp_bits=16, backend="cuda").fanout_prober(
        t32(tables), t32(stashes), n_buckets=512)
    np.testing.assert_array_equal(
        port(t32(hi), t32(lo)).numpy(),
        np.asarray(ref(jnp.asarray(hi), jnp.asarray(lo))))


def test_empty_batch_and_block_check():
    tables = torch.zeros((2, 64, 4), dtype=torch.int32)
    stashes = torch.zeros((2, 2, 8), dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    cuda.reset_counts()
    for got in (ops.filter_lookup_multi(tables, empty, empty, fp_bits=16),
                ops.multi_prober(tables, fp_bits=16,
                                 stashes=stashes)(empty, empty),
                probe_multi(tables, empty, empty, fp_bits=16)):
        assert got.shape == (0,) and got.dtype == torch.bool
    want = ref_ops.filter_lookup_multi(
        jnp.zeros((2, 64, 4), jnp.uint32), jnp.zeros(0, jnp.uint32),
        jnp.zeros(0, jnp.uint32), fp_bits=16, use_pallas="always")
    assert np.asarray(want).shape == (0,)
    keys = torch.zeros(1000, dtype=torch.int32)
    with pytest.raises(ValueError):
        probe_multi(tables, keys, keys, fp_bits=16, block=128)


def test_cpu_tensors_take_the_plain_version():
    cuda.reset_counts()
    hi, lo = split(random_keys(np.random.RandomState(6), 256))
    probe_multi(torch.zeros((3, 64, 4), dtype=torch.int32), t32(hi),
                t32(lo), fp_bits=16,
                stashes=torch.zeros((3, 2, 8), dtype=torch.int32))
    assert cuda.PLAIN_CALLS["probe_multi"] == 1
    assert sum(cuda.LAUNCHES.values()) == 0
