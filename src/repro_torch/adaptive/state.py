"""Device state of the adaptive (false-positive-learning) filter.

Counterpart of ``repro.adaptive.state``.  Four planes beside each other in
one preallocated pow2 buffer (OCF-style resizes change no tensor shape),
all int32 tensors holding uint32 bit patterns, like the port's table:

  * ``table`` — fingerprints, ``[buffer_buckets, bucket_size]``, 0 == EMPTY;
    a slot stores the SELECTED family member of its resident key;
  * ``sels`` — the packed 2-bit selector plane ``[buffer_buckets, 1]``
    (``kernels.selector``); all-zero behaves exactly like the static filter;
  * ``khi`` / ``klo`` — mirror key planes: the resident's key halves.

``count`` is a device scalar (int64) of table-resident fingerprints;
``n_buckets`` is the ACTIVE bucket count, a host int.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import hashing
from repro_torch.kernels.selector import make_key_planes, make_sel_plane


class AdaptiveState(NamedTuple):
    table: torch.Tensor   # int32[buffer_buckets, bucket_size]; 0 == EMPTY
    sels: torch.Tensor    # int32[buffer_buckets, 1] packed 2-bit selectors
    khi: torch.Tensor     # int32[buffer_buckets, bucket_size] mirror key hi
    klo: torch.Tensor     # int32[buffer_buckets, bucket_size] mirror key lo
    count: torch.Tensor   # int64[] live table fingerprints (device scalar)
    n_buckets: int        # ACTIVE bucket count (<= buffer_buckets)


def make_adaptive_state(n_buckets: int, bucket_size: int = 4,
                        buffer_buckets: Optional[int] = None, *,
                        device="cuda") -> AdaptiveState:
    """Empty four-plane state on ``device`` (raises if ``"cuda"`` has no
    card)."""
    dev = hashing.resolve_device(device)
    buf = buffer_buckets or n_buckets
    if buf < n_buckets:
        raise ValueError(f"buffer_buckets={buf} < n_buckets={n_buckets}")
    khi, klo = make_key_planes(buf, bucket_size, device=dev)
    return AdaptiveState(
        table=torch.zeros((buf, bucket_size), dtype=torch.int32, device=dev),
        sels=make_sel_plane(buf, device=dev), khi=khi, klo=klo,
        count=torch.zeros((), dtype=torch.int64, device=dev),
        n_buckets=int(n_buckets))
