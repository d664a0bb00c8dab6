"""Host-facing wrapper around the device-resident overflow stash.

Counterpart of ``repro.streaming.stash``.  The device math (layout, fused
match, rank-resolved spill) lives in ``repro_torch.kernels.stash``; this
module is the *policy* view the streaming subsystem holds: occupancy/fill
accounting for the admission signal, and one stash per filter generation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hashing import resolve_device
from repro_torch.kernels.stash import (DEFAULT_STASH_SLOTS, make_stash,
                                       stash_occupancy)


@dataclasses.dataclass
class OverflowStash:
    """A fixed-size overflow stash bound to one filter generation.

    ``array`` is the int32[2, slots] tensor the insert kernel updates in
    place (``FilterOps(donate=True).insert_spill``); the generation ring
    passes a view of its pool.  ``fill`` (occupancy /
    slots) is the first half of the admission congestion signal
    (``streaming.admission``).  ``device`` places a fresh ``array``.
    """

    slots: int = DEFAULT_STASH_SLOTS
    array: torch.Tensor = None  # type: ignore[assignment]
    device: str = "cuda"

    def __post_init__(self):
        if self.array is None:
            self.array = make_stash(self.slots, device=self.device)

    @property
    def occupancy(self) -> int:
        return int(stash_occupancy(self.array))

    @property
    def fill(self) -> float:
        return self.occupancy / self.slots


def make_sharded_stashes(n_shards: int, slots: int = DEFAULT_STASH_SLOTS, *,
                         device="cuda") -> torch.Tensor:
    """Per-shard stash stack: int32[n_shards, 2, slots] of zeros."""
    if n_shards <= 0 or slots <= 0:
        raise ValueError("need at least one shard and one slot")
    return torch.zeros((n_shards, 2, slots), dtype=torch.int32,
                       device=resolve_device(device))


def sharded_stash_fill(stashes: torch.Tensor) -> torch.Tensor:
    """Per-shard fill fraction -> float32[n_shards] (stays on the device).

    The max over shards is what a streaming control plane compares against
    the thresholds ``streaming.admission`` applies to one generation's
    ``OverflowStash.fill``.
    """
    occ = (stashes[:, 0, :] != 0).sum(dim=-1)
    return occ.to(torch.float32) / stashes.shape[-1]
