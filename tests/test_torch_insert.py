"""Kernel 3 (insert_bulk): the port's plain version against the
reference's XLA grid emulation (and its Pallas interpreter on a small
case), bit for bit: tables, stashes and ok masks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.insert import insert_bulk as ref_insert
from repro.kernels.probe import probe as ref_probe
from repro_torch.kernels import ops
from repro_torch.kernels.insert import insert_bulk, insert_once
from repro_torch.kernels.probe import probe

from torch_port_util import random_keys, split, t32, u32

pytestmark = pytest.mark.tier1


def _both(table, keys, *, n_buckets, block, rounds, valid=None,
          stash=None, schedule=False, interpret=False):
    """Run the reference and the port on the same inputs; assert equal
    outputs; return the port's (table, stash, ok) as numpy."""
    hi, lo = split(keys)
    n = keys.size
    valid = np.ones(n, bool) if valid is None else valid
    kw = dict(fp_bits=16, n_buckets=n_buckets, evict_rounds=rounds,
              block=block, schedule=schedule)
    ref_kw = dict(interpret=True) if interpret else dict(emulate=True)
    out = ref_insert(jnp.asarray(table), jnp.asarray(hi), jnp.asarray(lo),
                     valid=jnp.asarray(valid),
                     stash=None if stash is None else jnp.asarray(stash),
                     **kw, **ref_kw)
    pt = t32(table)
    ps = None if stash is None else t32(stash)
    got = insert_bulk(pt, t32(hi), t32(lo), valid=torch.from_numpy(valid),
                      stash=ps, **kw)
    assert got[0] is pt                                    # in place
    np.testing.assert_array_equal(u32(pt), np.asarray(out[0]))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(out[-1]))
    if stash is not None:
        assert got[1] is ps
        np.testing.assert_array_equal(u32(ps), np.asarray(out[1]))
    return u32(pt), None if ps is None else u32(ps), got[-1].numpy()


def _resident(table, keys, n_buckets, stash=None):
    hi, lo = split(keys)
    return probe(t32(table), t32(hi), t32(lo), fp_bits=16,
                 n_buckets=n_buckets, block=keys.size,
                 stash=None if stash is None else t32(stash)).numpy()


def test_single_block():
    keys = random_keys(np.random.RandomState(0), 1024)
    _t, _s, ok = _both(np.zeros((512, 4), np.uint32), keys, n_buckets=400,
                       block=1024, rounds=32)
    assert ok.sum() > 1000


def test_multiple_blocks_accumulate():
    rng = np.random.RandomState(1)
    table = np.zeros((1024, 4), np.uint32)
    first, second = random_keys(rng, 2048), random_keys(rng, 1536)
    table, _s, ok1 = _both(table, first, n_buckets=1000, block=128,
                           rounds=32)
    table, _s, ok2 = _both(table, second, n_buckets=1000, block=128,
                           rounds=32, valid=rng.rand(1536) < 0.9)
    assert ok1.all()
    assert _resident(table, first, 1000).all()


def test_eviction_storm_at_0p9_load():
    rng = np.random.RandomState(2)
    n_buckets = 1024
    keys = random_keys(rng, int(0.9 * n_buckets * 4) // 128 * 128)
    table, _s, ok = _both(np.zeros((n_buckets, 4), np.uint32), keys,
                          n_buckets=n_buckets, block=128, rounds=64)
    assert ok.mean() > 0.99
    assert _resident(table, keys[ok], n_buckets).all()


def test_small_budget_rolls_back():
    rng = np.random.RandomState(3)
    n_buckets = 512
    base_keys = random_keys(rng, 1792)
    table, _s, base_ok = _both(np.zeros((n_buckets, 4), np.uint32),
                               base_keys, n_buckets=n_buckets, block=128,
                               rounds=64)
    before = table.copy()
    more = random_keys(rng, 256)
    table, _s, ok = _both(table, more, n_buckets=n_buckets, block=128,
                          rounds=2)
    assert (~ok).sum() > 0                      # some lanes rolled back
    # a failed insert never orphans a resident fingerprint
    assert _resident(table, base_keys[base_ok], n_buckets).all()
    # the table differs from before only by the landed fingerprints
    assert (table != 0).sum() == (before != 0).sum() + ok.sum()


def test_stash_spill():
    rng = np.random.RandomState(4)
    n_buckets = 512
    keys = random_keys(rng, 2048)
    table, stash, ok = _both(np.zeros((n_buckets, 4), np.uint32), keys,
                             n_buckets=n_buckets, block=128, rounds=4,
                             stash=np.zeros((2, 32), np.uint32))
    assert (stash[0] != 0).sum() > 0 and (~ok).sum() > 0
    assert _resident(table, keys[ok], n_buckets, stash).all()


def test_stash_without_evictions():
    rng = np.random.RandomState(5)
    keys = random_keys(rng, 1024)
    _t, stash, ok = _both(np.zeros((256, 4), np.uint32), keys,
                          n_buckets=250, block=256, rounds=0,
                          stash=np.zeros((2, 64), np.uint32))
    assert (stash[0] != 0).all()


def test_schedule_prepass():
    rng = np.random.RandomState(6)
    keys = random_keys(rng, 4096)
    keys[2048:2300] = keys[:252]                # in-batch repeats
    _both(np.zeros((2048, 4), np.uint32), keys, n_buckets=1900, block=128,
          rounds=32, schedule=True, valid=rng.rand(4096) < 0.95)


def test_insert_once_is_zero_rounds():
    rng = np.random.RandomState(7)
    keys = random_keys(rng, 1024)
    hi, lo = split(keys)
    table, _s, ok = _both(np.zeros((256, 4), np.uint32), keys,
                          n_buckets=256, block=256, rounds=0)
    pt = torch.zeros((256, 4), dtype=torch.int32)
    _pt, ok2 = insert_once(pt, t32(hi), t32(lo), fp_bits=16, block=256)
    np.testing.assert_array_equal(u32(pt), table)
    np.testing.assert_array_equal(ok2.numpy(), ok)
    assert not ok.all()


def test_matches_interpreter():
    rng = np.random.RandomState(8)
    keys = random_keys(rng, 256)
    _both(np.zeros((64, 4), np.uint32), keys, n_buckets=60, block=128,
          rounds=4, stash=np.zeros((2, 8), np.uint32), interpret=True)


def test_empty_batch():
    table = torch.zeros((64, 4), dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    t, ok = insert_bulk(table, empty, empty, fp_bits=16)
    assert t is table and ok.shape == (0,)
    st = torch.zeros((2, 8), dtype=torch.int32)
    assert insert_bulk(table, empty, empty, fp_bits=16, stash=st)[1] is st
    out = ops.filter_insert(table, empty, empty, fp_bits=16, stash=st)
    assert out[-1].shape == (0,)
    with pytest.raises(ValueError):
        keys = torch.zeros(1000, dtype=torch.int32)
        insert_bulk(table, keys, keys, fp_bits=16, block=128)


@pytest.mark.parametrize("n,rounds,slots", [(1000, 32, 0), (5000, 8, 16)])
def test_filter_insert_padding_and_block_rule(n, rounds, slots):
    rng = np.random.RandomState(9)
    hi, lo = split(random_keys(rng, n))
    table = np.zeros((1024, 4), np.uint32)
    stash = np.zeros((2, slots), np.uint32) if slots else None
    kw = dict(fp_bits=16, n_buckets=1000, evict_rounds=rounds,
              schedule=True)
    ref = ref_ops.filter_insert(
        jnp.asarray(table), jnp.asarray(hi), jnp.asarray(lo),
        stash=None if stash is None else jnp.asarray(stash),
        use_pallas="always", **kw)
    pt = t32(table)
    got = ops.filter_insert(pt, t32(hi), t32(lo),
                            stash=None if stash is None else t32(stash), **kw)
    assert got[0] is not pt and (pt == 0).all()     # donate=False copies
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(
            u32(g) if g.dtype == torch.int32 else g.numpy(), np.asarray(r))
    donated = ops.filter_insert(pt, t32(hi), t32(lo), donate=True,
                                stash=None if stash is None else t32(stash),
                                **kw)
    assert donated[0] is pt
    np.testing.assert_array_equal(u32(pt), np.asarray(ref[0]))


def test_parity_block_rule_matches_reference():
    for op in ("probe", "insert", "delete"):
        for table_bytes in (0, 4096, 1 << 20, 3 << 20, 64 << 20):
            for n_keys in (None, 100, 1000, 4096):
                for rounds, slots in ((0, 0), (32, 0), (64, 128)):
                    kw = dict(table_bytes=table_bytes, evict_rounds=rounds,
                              stash_slots=slots, n_keys=n_keys)
                    assert ops.autotune_block(op, **kw) == \
                        ref_ops.autotune_block(op, **kw)
    # the OCF's 4096-key chunks get the 128-lane block at every size
    for table_bytes in (16 << 10, 1 << 20, 64 << 20):
        assert ops.autotune_block("insert", table_bytes=table_bytes,
                                  evict_rounds=32, n_keys=4096) == 128
        assert ops.autotune_block("delete", table_bytes=table_bytes,
                                  n_keys=4096) == 128
    assert ops.PARITY_VMEM_TABLE_BUDGET == ref_ops.VMEM_TABLE_BUDGET
    assert ops.PARITY_BLOCK_CANDIDATES == ref_ops._BLOCK_CANDIDATES
    assert ops.kernel_vmem_bytes("insert", table_bytes=1 << 20, block=128,
                                 evict_rounds=32, stash_slots=64) == \
        ref_ops.kernel_vmem_bytes("insert", table_bytes=1 << 20, block=128,
                                  evict_rounds=32, stash_slots=64)
