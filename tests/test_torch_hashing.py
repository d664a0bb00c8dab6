"""Port hash spec (repro_torch.core.hashing) against the reference's numpy
and jnp spellings, bit for bit, plus the device rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref
from repro_torch.core import hashing

from torch_port_util import random_keys, split, t32, u32

pytestmark = pytest.mark.tier1


def _keys(seed, n=4096):
    keys = random_keys(np.random.RandomState(seed), n)
    keys[:8] = [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 63, 2 ** 64 - 1, 7, 2 ** 40]
    return keys


def test_mixers_match_numpy_and_jnp():
    x = np.random.RandomState(1).randint(0, 2 ** 32, size=4096,
                                         dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    for port_fn, np_fn, jnp_fn in (
            (hashing.murmur3_mix, ref.murmur3_mix_np, ref.murmur3_mix),
            (hashing.splitmix32, ref.splitmix32_np, ref.splitmix32)):
        got = port_fn(t32(x)).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, np_fn(x))
        np.testing.assert_array_equal(got, np.asarray(jnp_fn(jnp.asarray(x))))
    np.testing.assert_array_equal(hashing.murmur3_mix_np(x),
                                  ref.murmur3_mix_np(x))
    np.testing.assert_array_equal(hashing.splitmix32_np(x),
                                  ref.splitmix32_np(x))


@pytest.mark.parametrize("fp_bits", [4, 8, 12, 16, 24, 32])
def test_fingerprint_matches(fp_bits):
    hi, lo = split(_keys(2))
    assert (hi != 0).any()
    want = ref.fingerprint_np(hi, lo, fp_bits)
    got = hashing.fingerprint(t32(hi), t32(lo), fp_bits).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    np.testing.assert_array_equal(
        want, np.asarray(ref.fingerprint(jnp.asarray(hi), jnp.asarray(lo),
                                         fp_bits)))
    np.testing.assert_array_equal(hashing.fingerprint_np(hi, lo, fp_bits),
                                  want)
    assert (got != 0).all() and (got < 2 ** fp_bits).all()


@pytest.mark.parametrize("n_buckets", [2, 7, 777, 1000, 4096, 999983,
                                       (1 << 22) - 9472])
def test_index_and_alt_match_and_involution(n_buckets):
    hi, lo = split(_keys(3))
    fp_np = ref.fingerprint_np(hi, lo, 16)
    i1_np = ref.index_hash_np(hi, lo, n_buckets)
    i2_np = ref.alt_index_np(i1_np, fp_np, n_buckets)
    th, tl = t32(hi), t32(lo)
    fp = hashing.fingerprint(th, tl, 16)
    i1 = hashing.index_hash(th, tl, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    np.testing.assert_array_equal(i1.numpy().astype(np.uint32), i1_np)
    np.testing.assert_array_equal(i2.numpy().astype(np.uint32), i2_np)
    i1_j = ref.index_hash_dyn(jnp.asarray(hi), jnp.asarray(lo), n_buckets)
    np.testing.assert_array_equal(np.asarray(i1_j), i1_np)
    np.testing.assert_array_equal(
        np.asarray(ref.alt_index_dyn(i1_j, jnp.asarray(fp_np), n_buckets)),
        i2_np)
    # the involution, in both spellings
    np.testing.assert_array_equal(hashing.alt_index(i2, fp, n_buckets), i1)
    np.testing.assert_array_equal(
        hashing.alt_index_np(i2_np, fp_np, n_buckets), i1_np)
    np.testing.assert_array_equal(hashing.index_hash_np(hi, lo, n_buckets),
                                  i1_np)
    assert (i2 < n_buckets).all()
    assert hashing.index_hash_dyn is hashing.index_hash
    assert hashing.alt_index_dyn is hashing.alt_index


def test_key_to_u32_pair():
    keys = _keys(4)
    hi, lo = split(keys)
    np.testing.assert_array_equal(hashing.key_to_u32_pair_np(keys)[0], hi)
    np.testing.assert_array_equal(hashing.key_to_u32_pair_np(keys)[1], lo)
    th, tl = hashing.key_to_u32_pair(torch.from_numpy(keys.view(np.int64)))
    assert th.dtype == tl.dtype == torch.int32
    np.testing.assert_array_equal(u32(th), hi)
    np.testing.assert_array_equal(u32(tl), lo)
    small = np.array([0, 5, -1], np.int32)
    zh, zl = hashing.key_to_u32_pair(torch.from_numpy(small))
    assert (zh == 0).all()
    np.testing.assert_array_equal(u32(zl), small.view(np.uint32))


def test_to_i32_round_trip():
    x = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    y = hashing.to_i32(x)
    assert y.dtype == torch.int32
    assert hashing.to_u32(y).tolist() == x.tolist()


def test_resolve_device_rule(monkeypatch):
    assert hashing.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hashing.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hashing.resolve_device("cuda")
    with pytest.raises(ValueError):
        hashing.resolve_device("meta")
