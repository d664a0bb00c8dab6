"""Kernel 4 (delete_bulk): the port's plain version against the
reference's XLA grid emulation (and its Pallas interpreter on a small
case), bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.delete import delete_bulk as ref_delete
from repro.kernels.insert import insert_bulk as ref_insert
from repro_torch.kernels import ops
from repro_torch.kernels.delete import delete_bulk

from torch_port_util import (STAGING_CASES, random_keys, split,
                             staging_inputs, t32, u32)

pytestmark = pytest.mark.tier1


def _table(rng, n_buckets, keys, buf=None):
    """Reference table holding ``keys`` (duplicates included)."""
    hi, lo = split(keys)
    table, ok = ref_insert(jnp.zeros((buf or n_buckets, 4), jnp.uint32),
                           jnp.asarray(hi), jnp.asarray(lo), fp_bits=16,
                           n_buckets=n_buckets, evict_rounds=64, block=128,
                           emulate=True)
    assert np.asarray(ok).all()
    return np.asarray(table)


def _both(table, keys, *, n_buckets, block, valid=None, interpret=False):
    hi, lo = split(keys)
    valid = np.ones(keys.size, bool) if valid is None else valid
    ref_kw = dict(interpret=True) if interpret else dict(emulate=True)
    rt, rok = ref_delete(jnp.asarray(table), jnp.asarray(hi),
                         jnp.asarray(lo), fp_bits=16, n_buckets=n_buckets,
                         valid=jnp.asarray(valid), block=block, **ref_kw)
    pt = t32(table)
    got_t, ok = delete_bulk(pt, t32(hi), t32(lo), fp_bits=16,
                            n_buckets=n_buckets,
                            valid=torch.from_numpy(valid), block=block)
    assert got_t is pt
    np.testing.assert_array_equal(u32(pt), np.asarray(rt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    return u32(pt), ok.numpy()


def test_duplicate_keys_clear_kth_copy():
    rng = np.random.RandomState(0)
    keys = random_keys(rng, 384)
    resident = np.concatenate([keys, keys[:128], keys[:128]])   # up to 3x
    table = _table(rng, 500, resident, buf=512)
    dele = np.concatenate([keys[:64]] * 4)      # one more than resident
    table, ok = _both(table, dele, n_buckets=500, block=256)
    assert ok[:192].all() and not ok[192:].any()
    assert (table != 0).sum() == resident.size - 192


def test_multiple_blocks_in_order():
    rng = np.random.RandomState(1)
    keys = random_keys(rng, 2048)
    table = _table(rng, 700, keys, buf=1024)
    dele = np.concatenate([keys[:1024], keys[:512], keys[1024:1536]])
    _t, ok = _both(table, dele, n_buckets=700, block=128)
    assert ok[:1024].all() and not ok[1024:1536].any() and ok[1536:].all()


def test_valid_mask_and_missing_keys():
    rng = np.random.RandomState(2)
    keys = random_keys(rng, 1024)
    table = _table(rng, 512, keys)
    absent = random_keys(rng, 512)
    dele = np.concatenate([keys[:512], absent])
    valid = rng.rand(1024) < 0.7
    table2, ok = _both(table, dele, n_buckets=512, block=128, valid=valid)
    assert not (ok & ~valid).any()
    assert ok[:512][valid[:512]].all()
    assert (table2 != 0).sum() == (table != 0).sum() - ok.sum()


def test_matches_interpreter():
    rng = np.random.RandomState(3)
    keys = random_keys(rng, 128)
    table = _table(rng, 120, np.concatenate([keys, keys]), buf=128)
    _both(table, np.concatenate([keys[:64], keys[:64]]), n_buckets=120,
          block=128, interpret=True)


@pytest.mark.parametrize("label", list(STAGING_CASES))
def test_staging_cases_match_reference(label):
    """The cases that stress the kernel's staged rows: deletes (keys
    resident twice, repeated across blocks) on the table the case's insert
    leaves, equal to the reference's."""
    c = staging_inputs(label)
    hi, lo = split(c["keys"])
    table, _ok = ref_insert(jnp.asarray(c["table"]), jnp.asarray(hi),
                            jnp.asarray(lo), fp_bits=16,
                            n_buckets=c["n_buckets"],
                            valid=jnp.asarray(c["valid"]),
                            evict_rounds=c["rounds"], block=c["block"],
                            emulate=True)
    _t, ok = _both(np.asarray(table), c["delete"], n_buckets=c["n_buckets"],
                   block=c["block"])
    n = c["keys"].size
    assert ok[: n // 2].any() and not ok[n // 2:].all()


@pytest.mark.parametrize("n", [1, 1000, 5000])
def test_filter_delete_padding_and_donate(n):
    rng = np.random.RandomState(4)
    keys = random_keys(rng, 4096)
    table = _table(rng, 1500, keys, buf=2048)
    hi, lo = split(np.concatenate([keys, keys])[:n])
    rt, rok = ref_ops.filter_delete(jnp.asarray(table), jnp.asarray(hi),
                                    jnp.asarray(lo), fp_bits=16,
                                    n_buckets=1500, use_pallas="always")
    pt = t32(table)
    got_t, ok = ops.filter_delete(pt, t32(hi), t32(lo), fp_bits=16,
                                  n_buckets=1500)
    assert got_t is not pt
    np.testing.assert_array_equal(u32(pt), table)      # input untouched
    np.testing.assert_array_equal(u32(got_t), np.asarray(rt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    same_t, _ok = ops.filter_delete(pt, t32(hi), t32(lo), fp_bits=16,
                                    n_buckets=1500, donate=True)
    assert same_t is pt
    np.testing.assert_array_equal(u32(pt), np.asarray(rt))


def test_empty_batch():
    table = torch.zeros((64, 4), dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    t, ok = delete_bulk(table, empty, empty, fp_bits=16)
    assert t is table and ok.shape == (0,)
    assert ops.filter_delete(table, empty, empty, fp_bits=16)[1].shape == (0,)
