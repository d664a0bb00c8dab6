"""The adaptive filter's shared math: the selector family (``sel_tweak``,
``fingerprint_sel``), the packed selector plane, ``fp_family`` /
``select_fp``, ``pair_rank``, ``stash_delete`` and the sequential report
pass ``report_adapt``, against the reference, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref_hashing
from repro.core.scheduling import pair_rank as ref_pair_rank
from repro.kernels import selector as ref_sel
from repro.kernels.stash import stash_delete_ref as ref_stash_delete
from repro_torch.core import hashing
from repro_torch.core.scheduling import pair_rank
from repro_torch.kernels import selector
from repro_torch.kernels.stash import stash_delete_ref

from torch_port_util import adaptive_planes, random_keys, split, t32, u32

pytestmark = pytest.mark.tier1


def test_sel_tweak_matches():
    sel = np.arange(8, dtype=np.uint32)           # masked to 2 bits
    want = ref_hashing.sel_tweak_np(sel)
    np.testing.assert_array_equal(hashing.sel_tweak_np(sel), want)
    np.testing.assert_array_equal(
        hashing.sel_tweak(torch.from_numpy(sel.astype(np.int64))).numpy(),
        want)
    np.testing.assert_array_equal(
        np.asarray(ref_hashing.sel_tweak(jnp.asarray(sel))), want)


@pytest.mark.parametrize("fp_bits", [4, 12, 16, 32])
def test_fingerprint_sel_matches_and_broadcasts(fp_bits):
    rng = np.random.RandomState(fp_bits)
    hi, lo = split(random_keys(rng, 512))
    hi[:2], lo[:2] = 0, [0, 0xFFFFFFFF]
    sels = rng.randint(0, 4, size=(512, 4)).astype(np.uint32)
    want = ref_hashing.fingerprint_sel_np(hi[:, None], lo[:, None], sels,
                                          fp_bits)
    np.testing.assert_array_equal(np.asarray(ref_hashing.fingerprint_sel(
        jnp.asarray(hi)[:, None], jnp.asarray(lo)[:, None],
        jnp.asarray(sels), fp_bits)), want)
    np.testing.assert_array_equal(
        hashing.fingerprint_sel_np(hi[:, None], lo[:, None], sels, fp_bits),
        want)
    got = hashing.fingerprint_sel(t32(hi)[:, None], t32(lo)[:, None],
                                  torch.from_numpy(sels.astype(np.int64)),
                                  fp_bits)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert want.min() >= 1
    # selector 0 is the static fingerprint
    np.testing.assert_array_equal(
        hashing.fingerprint_sel(t32(hi), t32(lo), 0, fp_bits).numpy(),
        hashing.fingerprint(t32(hi), t32(lo), fp_bits).numpy())


@pytest.mark.parametrize("bucket_size", [1, 4, 16])
def test_sel_pack_unpack(bucket_size):
    rng = np.random.RandomState(bucket_size)
    packed = rng.randint(0, 2 ** 32, size=(64, 1), dtype=np.uint64).astype(
        np.uint32)
    if bucket_size < 16:
        packed &= np.uint32((1 << (2 * bucket_size)) - 1)
    unpacked = np.asarray(ref_sel.sel_unpack(jnp.asarray(packed),
                                             bucket_size))
    got = selector.sel_unpack(t32(packed), bucket_size)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), unpacked)
    np.testing.assert_array_equal(u32(selector.sel_pack(got)), packed)
    np.testing.assert_array_equal(
        np.asarray(ref_sel.sel_pack(jnp.asarray(unpacked))), packed)


def test_fp_family_and_select_fp():
    rng = np.random.RandomState(3)
    hi, lo = split(random_keys(rng, 256))
    sels = rng.randint(0, 4, size=(256, 4)).astype(np.uint32)
    ref_fam = ref_sel.fp_family(jnp.asarray(hi), jnp.asarray(lo), 12)
    fam = selector.fp_family(t32(hi), t32(lo), 12)
    for a, b in zip(fam, ref_fam):
        np.testing.assert_array_equal(a.numpy().astype(np.uint32),
                                      np.asarray(b))
    np.testing.assert_array_equal(
        selector.select_fp(fam, torch.from_numpy(sels.astype(np.int64)))
        .numpy().astype(np.uint32),
        np.asarray(ref_sel.select_fp(ref_fam, jnp.asarray(sels))))


@pytest.mark.parametrize("groups", [3, 40])
def test_pair_rank_keeps_lane_order_in_ties(groups):
    rng = np.random.RandomState(groups)
    a = rng.randint(0, groups, size=600).astype(np.uint32)
    b = rng.randint(0, 3, size=600).astype(np.uint32)
    a[:4] = 0xFFFFFFFF                       # negative as int32
    valid = rng.rand(600) < 0.9
    want = np.asarray(ref_pair_rank(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(valid)))
    got = pair_rank(t32(a), t32(b), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    # ties: the k-th valid lane of an (a, b) group has rank k
    seen = {}
    for i in np.nonzero(valid)[0]:
        key = (a[i], b[i])
        assert got[i] == seen.get(key, 0)
        seen[key] = seen.get(key, 0) + 1


def test_stash_delete_clears_kth_copy():
    rng = np.random.RandomState(5)
    keys = random_keys(rng, 12)
    hi, lo = split(keys)
    nb = 37
    fp = ref_hashing.fingerprint_np(hi, lo, 16)
    i1 = ref_hashing.index_hash_np(hi, lo, nb)
    i2 = ref_hashing.alt_index_np(i1, fp, nb)
    stash = np.zeros((2, 32), np.uint32)
    # keys 0..5 parked twice (bound for either bucket), keys 6..11 once
    stash[0, :12], stash[1, :12] = np.tile(fp[:6], 2), np.tile(
        np.where(np.arange(6) % 2, i1[:6], i2[:6]), 2)
    stash[0, 14:20], stash[1, 14:20] = fp[6:], i2[6:]
    want_keys = np.concatenate([keys[:6], keys[:9], keys[:3]])
    w_hi, w_lo = split(want_keys)
    want = rng.rand(want_keys.size) < 0.9
    rs, rc = ref_stash_delete(jnp.asarray(stash), jnp.asarray(w_hi),
                              jnp.asarray(w_lo), jnp.asarray(want),
                              fp_bits=16, n_buckets=nb)
    ps = t32(stash)
    cleared = stash_delete_ref(ps, t32(w_hi), t32(w_lo),
                               torch.from_numpy(want), fp_bits=16,
                               n_buckets=nb)
    np.testing.assert_array_equal(u32(ps), np.asarray(rs))
    np.testing.assert_array_equal(cleared.numpy(), np.asarray(rc))
    assert cleared.any() and not cleared.all()


def _report_inputs(seed, nb, fp_bits):
    rng = np.random.RandomState(seed)
    table, sels, khi, klo, members = adaptive_planes(
        rng, nb, nb, 0.8, fp_bits=fp_bits)
    probes = random_keys(rng, 600)
    keys = np.concatenate([probes[:300], members[:20], probes[300:],
                           probes[:50]])             # repeats, residents
    return (table, sels, khi, klo), keys, rng.rand(keys.size) < 0.95


@pytest.mark.parametrize("seed,nb,fp_bits,fixed_points",
                         [(0, 7, 5, True), (1, 64, 6, False),
                          (2, 4096, 8, False)])
def test_report_adapt_matches(seed, nb, fp_bits, fixed_points):
    planes, keys, valid = _report_inputs(seed, nb, fp_bits)
    hi, lo = split(keys)
    fp = ref_hashing.fingerprint_np(hi, lo, fp_bits)
    i1 = ref_hashing.index_hash_np(hi, lo, nb)
    fixed = ref_hashing.alt_index_np(i1, fp, nb) == i1
    rt, rs, ra, rr = ref_sel.report_adapt(
        *(jnp.asarray(p) for p in planes), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(valid), fp_bits=fp_bits, n_buckets=nb)
    pt, ps = t32(planes[0]), t32(planes[1])
    _t, _s, adapted, resident = selector.report_adapt(
        pt, ps, t32(planes[2]), t32(planes[3]), t32(hi), t32(lo),
        torch.from_numpy(valid), fp_bits=fp_bits, n_buckets=nb)
    np.testing.assert_array_equal(u32(pt), np.asarray(rt))
    np.testing.assert_array_equal(u32(ps), np.asarray(rs))
    np.testing.assert_array_equal(adapted.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(resident.numpy(), np.asarray(rr))
    assert adapted.any() and resident.any()
    if fixed_points:          # i2 == i1 lanes that collide, adapted once
        assert (fixed & adapted.numpy()).any()
