"""The port's OCF-dedup data pipeline (``repro_torch.data.pipeline``)
against the reference's (``repro.data.pipeline``) on the CPU: the same
docs from ``SyntheticDocs``, the same content hashes, and through
``DedupPipeline`` the same batches, ``PipelineStats`` and OCF stats,
exactly, over a stream long enough that shards retire (their keys
deleted from the filter)."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core.ocf import OcfConfig as RefOcfConfig
from repro.data import pipeline as ref_pipe
from repro_torch.core.ocf import OcfConfig
from repro_torch.data import pipeline as port_pipe

pytestmark = pytest.mark.tier1


def test_synthetic_docs_and_hashes_match_reference():
    ref = ref_pipe.SyntheticDocs(vocab=300, doc_len=9, seed=3, burst=8)
    port = port_pipe.SyntheticDocs(vocab=300, doc_len=9, seed=3, burst=8)
    for a, b in itertools.islice(zip(ref, port), 400):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
        assert port_pipe.content_hash(b) == ref_pipe.content_hash(a)


def test_content_hash_is_order_sensitive():
    doc = np.arange(10, dtype=np.int32)
    assert port_pipe.content_hash(doc) != port_pipe.content_hash(doc[::-1])
    assert port_pipe.content_hash(doc) == ref_pipe.content_hash(doc)


@pytest.mark.parametrize("batches", [40])
def test_dedup_batches_and_stats_match_reference(batches):
    """Shards of 8 docs: the fifth opened shard retires the first (a
    verified delete of its 8 keys), again and again over the stream."""
    kw = dict(vocab=97, doc_len=9, seed=1, dup_rate=0.4, burst=6)
    ref = ref_pipe.DedupPipeline(
        ref_pipe.SyntheticDocs(**kw), batch=2, seq=12,
        ocf_config=RefOcfConfig(capacity=1024, mode="EOF", c_min=64),
        shard_docs=8)
    port = port_pipe.DedupPipeline(
        port_pipe.SyntheticDocs(**kw), batch=2, seq=12,
        ocf_config=OcfConfig(capacity=1024, mode="EOF", c_min=64,
                             device="cpu"), shard_docs=8)
    for i, (a, b) in enumerate(itertools.islice(zip(ref, port), batches)):
        for key in ("tokens", "targets"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{i}")
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(
            ref.stats), i
    assert port.stats.shards_retired >= 2 and port.stats.docs_deduped > 0
    assert dataclasses.asdict(port.ocf.stats) == dataclasses.asdict(
        ref.ocf.stats)
    assert port.ocf.capacity_history == ref.ocf.capacity_history
    assert len(port.ocf) == len(ref.ocf)


def test_default_filter_lives_on_the_given_device():
    pipe = port_pipe.DedupPipeline(iter([]), batch=1, seq=4, device="cpu")
    assert pipe.ocf.state.table.device.type == "cpu"
    assert pipe.ocf.config.capacity == 8192 and pipe.ocf.config.mode == "EOF"
