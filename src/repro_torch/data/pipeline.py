"""Synthetic token data pipeline with OCF dedup.

Counterpart of ``repro.data.pipeline`` (``content_hash``,
``PipelineStats``, ``SyntheticDocs``, ``DedupPipeline``).  A deterministic
document stream (fresh docs and re-emitted duplicates, in bursts) flows
through the port's ``OCF`` keyed on content hashes: a doc whose hash the
filter holds is dropped before batching, a new one is inserted, and an
aged-out shard of keys is deleted from the filter (``retire_oldest_shard``),
which shrinks it through the EOF controller.  The stream and the hashes
are numpy, as the reference's; the filter lives on ``device`` (``"cuda"``
by default, where lookups, inserts and deletes launch the fingerprint,
probe, insert and delete kernels; ``"cpu"`` runs their plain versions).
The same seed gives the same docs, batches, ``PipelineStats`` and OCF
stats as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.hashing import murmur3_mix_np, splitmix32_np
from repro_torch.core.ocf import OCF, OcfConfig


def content_hash(doc: np.ndarray) -> np.uint64:
    """Order-sensitive uint64 hash of a token document."""
    toks = np.asarray(doc, dtype=np.uint32)
    with np.errstate(over="ignore"):  # uint32 wraparound is the hash mix
        pos = splitmix32_np(np.arange(toks.size, dtype=np.uint32))
        lo = murmur3_mix_np(np.bitwise_xor.reduce(murmur3_mix_np(toks ^ pos)))
        hi = splitmix32_np(lo + np.uint32(toks.size))
    return (np.uint64(hi) << np.uint64(32)) | np.uint64(lo)


@dataclasses.dataclass
class PipelineStats:
    docs_seen: int = 0
    docs_deduped: int = 0
    batches: int = 0
    shards_retired: int = 0


class SyntheticDocs:
    """Deterministic doc stream; ``dup_rate`` of docs are repeats, emitted in
    bursts of up to ``burst``."""

    def __init__(self, vocab: int, doc_len: int = 128, seed: int = 0,
                 dup_rate: float = 0.3, burst: int = 64):
        self.vocab, self.doc_len = vocab, doc_len
        self.rng = np.random.RandomState(seed)
        self.dup_rate, self.burst = dup_rate, burst
        self._history: list[np.ndarray] = []

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            if (self._history and self.rng.rand() < self.dup_rate):
                for _ in range(self.rng.randint(1, self.burst)):
                    yield self._history[self.rng.randint(len(self._history))]
            doc = self.rng.randint(0, self.vocab,
                                   self.doc_len).astype(np.int32)
            if len(self._history) < 4096:
                self._history.append(doc)
            yield doc


class DedupPipeline:
    """Doc stream -> OCF dedup -> packed (tokens, targets) int32 numpy
    batches [batch, seq].  ``device``: where the default filter lives
    (``OcfConfig(capacity=8192, mode="EOF", device=device)``); a given
    ``ocf_config`` names its own."""

    def __init__(self, source: Iterator[np.ndarray], batch: int, seq: int,
                 ocf_config: Optional[OcfConfig] = None,
                 shard_docs: int = 4096, device: str = "cuda"):
        self.source = iter(source)
        self.batch, self.seq = batch, seq
        self.ocf = OCF(ocf_config or OcfConfig(capacity=8192, mode="EOF",
                                               device=device))
        self.stats = PipelineStats()
        self.shard_docs = shard_docs
        self._shard_keys: list[list[int]] = [[]]

    def _next_doc(self) -> np.ndarray:
        while True:
            doc = next(self.source)
            self.stats.docs_seen += 1
            key = content_hash(doc)
            if bool(self.ocf.lookup(np.array([key]))[0]):
                self.stats.docs_deduped += 1
                continue
            self.ocf.insert(np.array([key], dtype=np.uint64))
            self._shard_keys[-1].append(int(key))
            if len(self._shard_keys[-1]) >= self.shard_docs:
                self._shard_keys.append([])
                if len(self._shard_keys) > 4:
                    self.retire_oldest_shard()
            return doc

    def retire_oldest_shard(self) -> int:
        """Age out a data shard: verified-delete its keys from the filter
        -> the number of keys."""
        if not self._shard_keys or not self._shard_keys[0]:
            return 0
        keys = np.array(self._shard_keys.pop(0), dtype=np.uint64)
        self.ocf.delete(keys)
        self.stats.shards_retired += 1
        return keys.size

    def __iter__(self):
        buf = np.zeros(0, dtype=np.int32)
        need = self.batch * (self.seq + 1)
        while True:
            while buf.size < need:
                buf = np.concatenate([buf, self._next_doc()])
            flat = buf[:need].reshape(self.batch, self.seq + 1)
            buf = buf[need:]
            self.stats.batches += 1
            yield {"tokens": flat[:, :-1].copy(),
                   "targets": flat[:, 1:].copy()}
