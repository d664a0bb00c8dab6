"""Host-side batching helpers for the filter control plane.

Counterpart of ``repro.core.chunking``: one definition of the fixed-chunk
device-batch contract (chunk size, pad value, (hi, lo) split, validity
mask) for every host controller that feeds the ``FilterOps`` data plane.
Padding lanes carry ``valid=False`` and never touch a table.

Unlike the reference, a batch crosses to the device in one copy (all of its
chunks at once); each yielded chunk is a contiguous view of that copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing

CHUNK = 4096


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (buffer-pool sizing)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def collect_chunk_results(parts, ns, dtype=bool) -> np.ndarray:
    """Stack per-chunk device results and pull them back in ONE transfer.

    ``parts`` are the fixed-``CHUNK``-shaped result tensors a batched op
    queued (one per ``key_chunks`` batch), ``ns`` the real lane counts.
    """
    if not parts:
        return np.zeros((0,), dtype)
    stacked = torch.stack(parts).cpu().numpy()
    out = np.empty((sum(ns),), stacked.dtype)
    off = 0
    for i, n in enumerate(ns):
        out[off:off + n] = stacked[i, :n]
        off += n
    return out


def key_chunks(keys: np.ndarray, chunk: int = CHUNK, *,
               with_valid: bool = True, device):
    """Yield (hi, lo, valid, n_real) fixed-size batches on ``device``.

    ``hi`` / ``lo`` are int32 tensors holding the uint32 halves of each key.
    The tail chunk is zero-padded with ``valid=False`` lanes.  Lookup paths
    pass ``with_valid=False`` (yielding ``valid=None``): probes ignore the
    mask — padding lanes probe the zero key and are sliced off.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    total = keys.size
    if total == 0:
        return
    padded = -(-total // chunk) * chunk
    if padded != total:
        keys = np.pad(keys, (0, padded - total))
    hi_np, lo_np = hashing.key_to_u32_pair_np(keys)
    hi = torch.from_numpy(hi_np.view(np.int32)).to(device)
    lo = torch.from_numpy(lo_np.view(np.int32)).to(device)
    valid = None
    if with_valid:
        valid_np = np.zeros(padded, bool)
        valid_np[:total] = True
        valid = torch.from_numpy(valid_np).to(device)
    for i in range(0, padded, chunk):
        n = min(chunk, total - i)
        yield (hi[i:i + chunk], lo[i:i + chunk],
               None if valid is None else valid[i:i + chunk], n)
