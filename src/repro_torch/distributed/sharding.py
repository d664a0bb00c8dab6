"""Placement of a sharded filter state on its mesh, and the training
step's ``ParallelConfig``.

Counterpart of ``repro.distributed.sharding.shard_filter_state`` and
``ParallelConfig``.  A ``ShardMesh`` holds every shard on one device, so
placing a state moves each tensor field whose leading dimension is the
shard count there; other fields (``n_buckets``) pass through.  The
reference module's LM specs wait for the LM stack's mesh.

``ParallelConfig`` carries every field of the reference's.  On one card
only ``remat``, ``microbatches`` and ``compress_grads`` /
``compress_int8`` act (the last two only with a ``pod_axis``, as in the
reference's train step); the mesh fields are carried and inert until the
port has a mesh for the LM stack.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None      # set for the multi-pod mesh
    pod_fsdp: bool = False              # shard params over (pod, data)
    compress_grads: bool = False        # bf16 cross-pod gradient round trip
    compress_int8: bool = False         # int8 instead of bf16
    remat: str = "none"                 # none | full | dots
    microbatches: int = 1
    seq_shard: bool = False             # sequence-sharded activations (SP)
    layout: str = "tp_fsdp"             # tp_fsdp | fsdp_only | tp_only
    ep_axis: str = "model"              # model | data  (expert placement)
    # mesh axis sizes, (("data", 16), ("model", 16), ...)
    axis_sizes: Optional[tuple] = None

    def size_of(self, axis: str) -> int:
        if not self.axis_sizes:
            return 0
        return dict(self.axis_sizes).get(axis, 0)

    def batch_axes(self):
        axes = ((self.pod_axis, self.data_axis) if self.pod_axis
                else (self.data_axis,))
        if self.layout == "fsdp_only":
            # no TP: the model axis carries extra data parallelism
            axes = (*axes, self.model_axis)
        return axes


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
