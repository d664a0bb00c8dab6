"""Dynamic-capacity filter state.

Counterpart of ``FilterState`` / ``make_state`` in ``repro.core.filter``.
The table lives in a preallocated pow2 buffer; the ACTIVE bucket count
``n_buckets`` is a host ``int`` handed to every kernel as a plain argument
(the TPU kept it in a ``(1, 1)`` SMEM scalar), so a resize changes no
tensor shape.  ``count`` stays a device scalar, so ops do not sync.

The reference's scan-based ``bulk_*`` backend is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import hashing


class FilterState(NamedTuple):
    table: torch.Tensor   # int32[buffer_buckets, bucket_size]; 0 == EMPTY
    count: torch.Tensor   # int64[] live table fingerprints (device scalar)
    n_buckets: int        # ACTIVE bucket count (<= buffer_buckets)


def make_state(n_buckets: int, bucket_size: int = 4,
               buffer_buckets: Optional[int] = None, *,
               device="cuda") -> FilterState:
    """Empty state on ``device`` (raises if ``"cuda"`` has no card)."""
    dev = hashing.resolve_device(device)
    buf = buffer_buckets or n_buckets
    if buf < n_buckets:
        raise ValueError(f"buffer_buckets={buf} < n_buckets={n_buckets}")
    return FilterState(
        table=torch.zeros((buf, bucket_size), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int64, device=dev),
        n_buckets=int(n_buckets))
