"""Placement of a sharded filter state on its mesh.

Counterpart of ``repro.distributed.sharding.shard_filter_state``.  A
``ShardMesh`` holds every shard on one device, so placing a state moves
each tensor field whose leading dimension is the shard count there; other
fields (``n_buckets``) pass through.  The reference module's LM specs wait
for the LM stack's mesh.
"""
from __future__ import annotations

import torch


def shard_filter_state(mesh, axis: str, state):
    """Move a ``ShardedFilterState``'s [n_shards, ...] tensors (tables,
    stashes) onto ``mesh``'s device -> the same NamedTuple type."""
    n_shards = mesh.shape[axis]

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                and x.shape[0] == n_shards:
            return x.to(mesh.device)
        return x

    return type(state)(*(place(x) for x in state))
