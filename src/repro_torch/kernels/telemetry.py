"""Device-resident telemetry planes of the filter kernels.

Counterpart of ``repro.kernels.telemetry``.  Every kernel entry point keeps
its signature; a *twin* (``*_tm`` in ``kernels/ops.py``) returns a
``FilterTelemetry`` beside the normal results.  On the card the insert and
probe twins launch the kernels' telemetry instantiations, which count
inside the kernel and write one small plane a launch; the telemetry-off
entry points launch the same kernels they always did.

The reference's fields are ``uint32``.  torch's ``uint32`` has no add,
maximum or comparison on the CPU, so the port's fields are ``int64``
tensors that hold uint32 values: ``merge`` adds and masks with
``0xFFFFFFFF`` (the reference's wrap-around), and takes the maximum for
``stash_fill_hw`` (a high-water mark).  That makes ``merge`` associative
and commutative.

Kick-depth histogram bins are powers of two over the eviction-chain
length: ``0, 1, 2, 3-4, 5-8, 9-16, 17-32, 33+``.  A lane that placed
without kicking lands in bin 0.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

KICK_BINS = 8
PROBE_DEPTHS = 4  # b1-hit, b2-hit, stash-hit, miss

# Inclusive upper edge of each histogram bin except the open-topped last.
KICK_EDGES = (0, 1, 2, 4, 8, 16, 32)
U32_MASK = 0xFFFFFFFF


class FilterTelemetry(NamedTuple):
    """Per-wave device counters: int64 tensors holding uint32 values."""

    kick_hist: torch.Tensor      # (KICK_BINS,) eviction-chain depths
    probe_depth: torch.Tensor    # (PROBE_DEPTHS,) lookup hit depths
    stash_spills: torch.Tensor   # () lanes spilled to the stash
    stash_fill_hw: torch.Tensor  # () stash occupancy high-water (max)
    rollback_lanes: torch.Tensor  # () lanes rolled back after a failed chain
    selector_bumps: torch.Tensor  # () adaptive selector rewrites applied
    overflow_lanes: torch.Tensor  # () routed-write lanes bounced to the host
    table_deletes: torch.Tensor  # () deletes resolved in the bucket table
    stash_deletes: torch.Tensor  # () deletes resolved in the stash


# The flat plane: the nine fields in order, one int64[PLANE_SIZE] tensor;
# OFFSET[name] is a field's first element there.
FIELD_SIZES = (KICK_BINS, PROBE_DEPTHS, 1, 1, 1, 1, 1, 1, 1)
PLANE_SIZE = sum(FIELD_SIZES)
OFFSET = dict(zip(FilterTelemetry._fields,
                  (sum(FIELD_SIZES[:i]) for i in range(len(FIELD_SIZES)))))


def empty_telemetry(device="cpu") -> FilterTelemetry:
    """An all-zero counter plane on ``device``, built fresh on every call
    (torch tensors are mutable, so no instance is shared)."""
    return unpack(_zeros(device))


def _zeros(device) -> torch.Tensor:
    return torch.zeros((PLANE_SIZE,), dtype=torch.int64, device=device)


def pack(tm: FilterTelemetry) -> torch.Tensor:
    """The nine fields as one flat int64[PLANE_SIZE] tensor, in order: the
    tensor they are views of when ``unpack`` made them, else a copy."""
    base = tm.kick_hist._base
    if (base is not None and base.shape == (PLANE_SIZE,)
            and base.dtype == torch.int64
            and all(f._base is base and f.storage_offset()
                    == base.storage_offset() + OFFSET[name]
                    for name, f in zip(FilterTelemetry._fields, tm))):
        return base
    return torch.cat([f.reshape(-1) for f in tm])


def unpack(flat: torch.Tensor) -> FilterTelemetry:
    """Inverse of ``pack`` (the fields are views of ``flat``)."""
    k, d = KICK_BINS, KICK_BINS + PROBE_DEPTHS
    return FilterTelemetry(flat[:k], flat[k:d], *flat[d:].unbind(0))


def merge(a: FilterTelemetry, b: FilterTelemetry) -> FilterTelemetry:
    """Fold two waves' counters: add everywhere (mod 2^32), max for the
    high-water."""
    return FilterTelemetry(*(
        torch.maximum(x, y) if name == "stash_fill_hw" else (x + y) & U32_MASK
        for name, x, y in zip(FilterTelemetry._fields, a, b)))


def kick_histogram(steps: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Histogram per-lane kick counts ``steps`` of the lanes in ``mask``
    into the fixed pow2 bins -> int64[KICK_BINS]."""
    edges = torch.tensor(KICK_EDGES, dtype=torch.int64, device=steps.device)
    idx = (steps.to(torch.int64)[:, None] > edges[None, :]).sum(dim=1)
    bins = torch.arange(KICK_BINS, device=steps.device)
    return ((idx[:, None] == bins[None, :]) & mask[:, None]).sum(dim=0)


def probe_depth_counts(h1: torch.Tensor, h2: torch.Tensor, hs: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Count lookup lanes by the depth at which they hit -> int64[4]: first
    bucket, second bucket, stash, miss.  A lane counts at its shallowest
    hit (an accounting convention, not a claim about execution order)."""
    d1 = h1 & valid
    d2 = h2 & ~h1 & valid
    ds = hs & ~h1 & ~h2 & valid
    miss = ~(h1 | h2 | hs) & valid
    return torch.stack([d1.sum(), d2.sum(), ds.sum(), miss.sum()])


def insert_plane(steps: torch.Tensor, spilled: torch.Tensor,
                 failed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """An insert's counters from its per-lane stats -> int64[KICK_BINS + 2]:
    the kick histogram over ``valid`` lanes, then spills, then rollbacks
    (the layout the kernels' telemetry instantiations write)."""
    return torch.cat([kick_histogram(steps, valid),
                      spilled.sum().reshape(1), failed.sum().reshape(1)])


@functools.lru_cache(maxsize=None)
def _insert_slots(device: torch.device) -> torch.Tensor:
    """Where an insert plane's elements go in the flat plane."""
    return torch.tensor([*range(KICK_BINS), OFFSET["stash_spills"],
                         OFFSET["rollback_lanes"]], device=device)


def from_insert_plane(plane: torch.Tensor,
                      stash_fill: torch.Tensor | None = None
                      ) -> FilterTelemetry:
    """A ``FilterTelemetry`` from an insert plane (``insert_plane``'s
    layout, int64) and the stash occupancy after the call (an insert only
    grows the stash, so that is its high-water mark): one flat plane on
    the device, a few kernels, no host sync."""
    flat = _zeros(plane.device)
    flat.index_copy_(0, _insert_slots(plane.device), plane)
    if stash_fill is not None:
        flat[OFFSET["stash_fill_hw"]] = stash_fill
    return unpack(flat)


def from_counts(device, *, probe_depth: torch.Tensor | None = None,
                **scalars: torch.Tensor) -> FilterTelemetry:
    """A ``FilterTelemetry`` holding a probe-depth plane and/or scalar
    counters (0-dim tensors on ``device``), zero elsewhere."""
    flat = _zeros(device)
    if probe_depth is not None:
        off = OFFSET["probe_depth"]
        flat[off:off + PROBE_DEPTHS] = probe_depth
    for name, value in scalars.items():
        flat[OFFSET[name]] = value
    return unpack(flat)


__all__ = [
    "KICK_BINS", "KICK_EDGES", "OFFSET", "PROBE_DEPTHS", "PLANE_SIZE",
    "FilterTelemetry", "empty_telemetry", "merge", "kick_histogram",
    "probe_depth_counts", "insert_plane", "from_insert_plane",
    "from_counts", "pack", "unpack",
]
