"""The port's prefix-cache indexes (``repro_torch.serving.kvcache``) on the
CPU against the reference's, driven with the same token streams: block
hashes, every answer and every stat equal, and the ring-backed index's
whole ring state equal after every call.  Mirrors
``tests/test_serving_kvcache.py`` and
``test_generational_prefix_index_promotes_hot_blocks`` of
``tests/test_streaming.py``."""
import dataclasses

import numpy as np
import pytest

from repro.core.ocf import OcfConfig as RefOcfConfig
from repro.serving.kvcache import GenerationalPrefixIndex as RefGenIndex
from repro.serving.kvcache import PrefixCacheIndex as RefIndex
from repro.serving.kvcache import block_hashes as ref_block_hashes
from repro_torch.convert import generational_from_numpy
from repro_torch.core.ocf import OcfConfig
from repro_torch.serving import (GenerationalPrefixIndex, PrefixCacheIndex,
                                 block_hashes)
from repro_torch.streaming import GenerationConfig

from torch_port_util import (assert_same_ring, assert_same_state,
                             port_snapshot, ref_ring_snapshot, ref_snapshot)

pytestmark = pytest.mark.tier1


@pytest.fixture
def rng():
    return np.random.RandomState(0)


class Indexes:
    """A reference index and a port index; every call goes to both and
    answers, stats and filter state are compared after it."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port
        self.check("start")

    def check(self, where):
        assert dataclasses.asdict(self.ref.stats) == \
            dataclasses.asdict(self.port.stats), where
        if hasattr(self.ref, "filt"):
            assert_same_ring(self.ref.filt, self.port.filt, where)
        else:
            assert_same_state(ref_snapshot(self.ref.ocf),
                              port_snapshot(self.port.ocf), where)
            assert self.ref._lru == self.port._lru, where

    def __getattr__(self, op):
        def call(*args, **kw):
            a = getattr(self.ref, op)(*args, **kw)
            b = getattr(self.port, op)(*args, **kw)
            assert a == b, (op, a, b)
            self.check(op)
            return b
        return call


def _ocf_indexes(**kw):
    ref_cfg = kw.pop("ref_config", None)
    cfg = kw.pop("config", None)
    return Indexes(RefIndex(ref_cfg, backend="pallas", **kw),
                   PrefixCacheIndex(cfg, device="cpu", **kw))


def test_block_hashes_prefix_sensitivity(rng):
    t1 = rng.randint(0, 1000, 256).astype(np.int32)
    t2 = t1.copy()
    t2[3] = (t2[3] + 1) % 1000
    k1, k2 = block_hashes(t1, 64), block_hashes(t2, 64)
    assert k1.shape == (4,)
    assert (k1 != k2).all()
    t3 = t1.copy()
    t3[200] += 1
    k3 = block_hashes(t3, 64)
    assert (k1[:3] == k3[:3]).all() and k1[3] != k3[3]
    for t in (t1, t2, t3):
        np.testing.assert_array_equal(block_hashes(t, 16),
                                      ref_block_hashes(t, 16))


def test_match_admit_evict_cycle(rng):
    idx = _ocf_indexes(block=32)
    prompt = rng.randint(0, 1000, 256).astype(np.int32)
    assert idx.match_prefix(prompt) == 0
    idx.admit(prompt)
    assert idx.match_prefix(prompt) == 8
    longer = np.concatenate([prompt,
                             rng.randint(0, 1000, 64).astype(np.int32)])
    assert idx.match_prefix(longer) == 8
    idx.evict(prompt)
    assert idx.match_prefix(prompt) == 0
    assert idx.port.hit_rate == idx.ref.hit_rate


def test_lru_eviction_deletes_from_filter(rng):
    idx = _ocf_indexes(block=32, max_blocks=8)
    for _ in range(6):
        idx.admit(rng.randint(0, 1000, 128).astype(np.int32))
    assert idx.port.stats.evicted > 0
    assert len(idx.port._lru) <= 8
    assert idx.port.ocf.stats.deletes > 0


def test_burst_admission_resizes_filter(rng):
    idx = _ocf_indexes(ref_config=RefOcfConfig(capacity=1024, mode="EOF"),
                       config=OcfConfig(capacity=1024, mode="EOF",
                                        device="cpu"),
                       block=16, max_blocks=1 << 20)
    for _ in range(40):
        idx.admit(rng.randint(0, 10000, 512).astype(np.int32))
    assert idx.port.ocf.stats.resizes >= 1
    assert idx.port.ocf.occupancy <= 0.96


def _gen_indexes(**kw):
    ref = RefGenIndex(block=32, backend="pallas", capacity=1024,
                      generations=2, now=0.0, **kw)
    port = GenerationalPrefixIndex(block=32, capacity=1024, generations=2,
                                   now=0.0, device="cpu", **kw)
    # both rings from the same state, through the converter
    port.filt = generational_from_numpy(
        GenerationConfig(capacity=1024, generations=2, device="cpu", **kw),
        **ref_ring_snapshot(ref.filt))
    return Indexes(ref, port)


def test_generational_prefix_index_promotes_hot_blocks(rng):
    idx = _gen_indexes()
    hot = rng.randint(0, 1000, size=128).astype(np.uint32)
    idx.admit(hot, now=0.0)
    for t in range(1, 4):                    # 3 rotations > K=2
        assert idx.match_prefix(hot, now=float(t)) == 4   # promotes
        idx.ref.filt.rotate(now=float(t))
        idx.port.filt.rotate(now=float(t))
        idx.check(f"rotate {t}")
    assert idx.match_prefix(hot, now=10.0) == 4
    assert idx.evict(hot) == 0
    cold = rng.randint(0, 1000, size=128).astype(np.uint32)
    idx2 = _gen_indexes()
    idx2.admit(cold, now=0.0)
    for t in range(1, 4):
        idx2.ref.filt.rotate(now=float(t))
        idx2.port.filt.rotate(now=float(t))
    idx2.check("rotations")
    assert idx2.match_prefix(cold, now=10.0) == 0


def test_generational_prefix_index_ttl_stream(rng):
    """Shared-prefix prompts over a logical clock with a TTL: matches,
    promotions, admissions and expiries equal to the reference's."""
    idx = _gen_indexes(ttl=4.0)
    system = rng.randint(0, 1000, size=64).astype(np.uint32)
    for t in range(8):
        user = rng.randint(0, 1000, size=96 + 32 * (t % 3)).astype(np.uint32)
        prompt = np.concatenate([system, user])
        idx.match_prefix(prompt, now=float(t))
        idx.admit(prompt, now=float(t))
    assert idx.port.stats.block_hits > 0
    assert idx.port.filt.stats.expirations > 0
