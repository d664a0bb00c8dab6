"""Logical-axis -> mesh-axis sharding rules (FSDP x TP x EP x pod-DP),
their DTensor placements, and the placement of a sharded filter state.

Counterpart of ``repro.distributed.sharding``.  Every parameter dim has a
*logical* name (``launch.specs.param_specs``); this module turns those
names into a mesh-axis tuple a tensor dim, the reference's
``PartitionSpec`` written as a plain tuple (an entry is ``None``, one
mesh-axis name, or a tuple of names, major to minor; trailing ``None``s
are dropped, as ``PartitionSpec`` drops them):

  expert -> model   (expert parallelism)
  vocab/heads/kv/mlp/rnn/lora -> model   (Megatron TP)
  embed -> data     (FSDP: weights sharded over the DP axis, gathered at
                     their use)
  mem   -> data

Each mesh axis is used at most once a tensor (``PRIORITY`` order); a dim
that does not divide falls back to its last axis alone, else to
replication.  ``pod``: pure data parallelism by default, FSDP over (pod,
data) with ``pod_fsdp=True``.

A mesh is anything with a ``.shape`` mapping axis names to sizes (the
reference's rules read nothing else) or a ``torch.distributed``
``DeviceMesh`` with ``mesh_dim_names``.  ``to_placements`` turns a tuple
into DTensor placements: a dim on ``("pod", "data")`` is ``Shard(d)`` on
both mesh dims, in that order, which DTensor splits major to minor, as
JAX does (``local_shape_and_offset`` gives a rank's block).

``ParallelConfig`` carries every field of the reference's.  On one card
only ``remat``, ``microbatches`` and ``compress_grads`` /
``compress_int8`` act (the last two only with a ``pod_axis``); with
``axis_sizes`` and DTensor weights (the dry-run) the use-site and
activation constraints act too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

PRIORITY = ["expert", "vocab", "heads", "kv", "mlp", "rnn", "lora", "embed",
            "mem"]
AXIS_FOR = {
    "expert": "model", "vocab": "model", "heads": "model", "kv": "model",
    "mlp": "model", "rnn": "model", "lora": "model",
    "embed": "data", "mem": "data",
}


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


# ------------------------------------------------------------------ mesh --


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a mesh with a ``.shape``
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _mesh_axis(logical: str, parallel: ParallelConfig):
    a = AXIS_FOR.get(logical)
    if logical == "expert" and parallel.ep_axis == "data":
        # EP over the data axis: the dispatch becomes the MoE all-to-all
        return parallel.data_axis
    if parallel.layout == "fsdp_only" and a == "model":
        return None           # weights replicated across the model axis
    if parallel.layout == "tp_only" and a == "data":
        return None           # no FSDP: weights whole per TP rank
    if a == "data":
        if parallel.pod_fsdp and parallel.pod_axis:
            return (parallel.pod_axis, parallel.data_axis)
        return parallel.data_axis
    if a == "model":
        return parallel.model_axis
    return None


def _trim(spec: list) -> tuple:
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def spec_to_pspec(spec: tuple, shape: tuple, mesh,
                  parallel: ParallelConfig) -> tuple:
    """One tensor's logical spec -> its mesh-axis tuple, with the
    reference's priority order and divisibility fallback."""
    sizes = axis_sizes(mesh)
    used: set = set()
    assign: dict[int, Any] = {}
    order = sorted(range(len(spec)),
                   key=lambda i: PRIORITY.index(spec[i])
                   if spec[i] in PRIORITY else len(PRIORITY))
    for i in order:
        name = spec[i]
        if name is None or name == "layers":
            continue
        ax = _mesh_axis(name, parallel)
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a in used for a in axes):
            continue
        size = 1
        for a in axes:
            size *= sizes[a]
        if shape[i] % size != 0:
            # fall back to the last axis alone if that divides
            if (len(axes) > 1 and shape[i] % sizes[axes[-1]] == 0
                    and axes[-1] not in used):
                axes = (axes[-1],)
            else:
                continue
        used.update(axes)
        assign[i] = axes if len(axes) > 1 else axes[0]
    return _trim([assign.get(i) for i in range(len(spec))])


def make_shardings(mesh, specs: dict, shapes: dict,
                   parallel: ParallelConfig) -> dict:
    """``{name: logical spec}`` and ``{name: tensor or shape}`` -> ``{name:
    mesh-axis tuple}``."""
    def shape_of(s):
        return tuple(s.shape) if hasattr(s, "shape") else tuple(s)
    return {k: spec_to_pspec(tuple(specs[k]), shape_of(shapes[k]), mesh,
                             parallel) for k in specs}


def batch_pspec(batch_size: int, ndim: int, mesh, parallel: ParallelConfig,
                *, seq_dim: int | None = None) -> tuple:
    """A [B, ...] input: batch over (pod,)data when divisible, else over
    data; the sequence over model with ``seq_shard``."""
    sizes = axis_sizes(mesh)
    axes = parallel.batch_axes()
    size = 1
    for a in axes:
        size *= sizes[a]
    first = None
    if batch_size % size == 0:
        first = axes if len(axes) > 1 else axes[0]
    elif batch_size % sizes[parallel.data_axis] == 0:
        first = parallel.data_axis
    spec = [first] + [None] * (ndim - 1)
    if parallel.seq_shard and seq_dim is not None and first is not None:
        spec[seq_dim] = parallel.model_axis
    return _trim(spec)


def cache_pspec(shape: tuple, mesh, parallel: ParallelConfig) -> tuple:
    """KV and state caches [n_periods, B, ...]: batch over data; a KV or
    MLA-latent cache's sequence dim over model (context-parallel decode);
    a state without a long sequence dim (SSM, RG-LRU) over its feature
    dim."""
    sizes = axis_sizes(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim
    if ndim >= 2 and shape[1] % sizes[parallel.data_axis] == 0:
        spec[1] = parallel.data_axis
    m = sizes[parallel.model_axis]
    if ndim >= 4 and shape[-2] % m == 0 and shape[-2] >= 16 * m:
        spec[-2] = parallel.model_axis      # seq dim (KV / MLA-latent cache)
    elif shape[-1] % m == 0 and shape[-1] >= 16:
        spec[-1] = parallel.model_axis      # feature dim (SSM/RG-LRU states)
    return _trim(spec)


# ------------------------------------------------------------- DTensor --


def to_placements(pspec: tuple, mesh) -> list:
    """A mesh-axis tuple -> one DTensor placement a mesh dim: ``Shard(d)``
    on every mesh dim that tensor dim d names, ``Replicate()`` elsewhere.
    A dim on several axes must name them in mesh order (major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} on {axes}: axes must follow the "
                             f"mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape_and_offset(shape: tuple, mesh, pspec: tuple,
                           coordinate=None) -> tuple:
    """(local shape, global offset) of the block of a tensor of ``shape``
    laid out by ``pspec`` at a mesh ``coordinate`` (this rank's by
    default)."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
        compute_local_shape_and_global_offset)
    placements = to_placements(pspec, mesh)
    if coordinate is None:
        return compute_local_shape_and_global_offset(shape, mesh, placements)
    return _compute_local_shape_and_global_offset(
        shape, tuple(mesh.shape), list(coordinate), placements)


def distribute(t: torch.Tensor, mesh, pspec: tuple, *,
               requires_grad: bool = False):
    """A DTensor laid out by ``pspec`` whose local block is this rank's
    block of ``t``.  A meta tensor gives a meta block (nothing moves)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(pspec, mesh)
    if t.is_meta:
        local, _ = local_shape_and_offset(tuple(t.shape), mesh, pspec)
        out = DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh,
            placements, run_check=False, shape=t.shape, stride=t.stride())
    else:
        out = distribute_tensor(t.detach(), mesh, placements)
    return out.requires_grad_(requires_grad)


def is_dtensor(t) -> bool:
    """True for a ``torch.distributed`` DTensor (no import without one)."""
    return type(t).__name__ == "DTensor" and hasattr(t, "placements")


def split_last(t, *sizes):
    """``t`` [..., prod(sizes)] -> [..., *sizes].  DTensor cannot split a
    dim sharded over more ranks than the leading factor divides by (four
    heads over a 16-way model axis): such a DTensor is made whole in that
    dim first."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.ndim - 1
        mesh = t.device_mesh
        n = 1
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == last:
                n *= mesh.size(i)
        if sizes[0] % n:
            t = t.redistribute(mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in t.placements])
    return t.reshape(*t.shape[:-1], *sizes)


def unsplit_rows(t, like, shape):
    """``t`` [G, T, ...] -> ``shape`` [B, S, ...] (rows regrouped into
    ``like``'s batch).  Where DTensor ``t``'s groups are sharded over mesh
    dims that do not shard ``like``'s batch, or its tokens are sharded at
    all, they are gathered first: DTensor cannot regroup rows split finer
    than the batch."""
    if is_dtensor(t) and is_dtensor(like):
        from torch.distributed.tensor import Replicate, Shard
        keep = [isinstance(q, Shard) and q.dim == 0 for q in like.placements]
        placements = [Replicate() if isinstance(p, Shard) and (
            p.dim == 1 or p.dim == 0 and not k) else p
            for p, k in zip(t.placements, keep)]
        if placements != list(t.placements):
            t = t.redistribute(t.device_mesh, placements)
    return t.reshape(shape)


def tp_matmul(x, w, *, reduced: bool = False):
    """``x @ w`` for activations x [..., K] and a weight ``w`` [K, N]: on
    DTensors one block a rank, so that DTensor chooses no layout of its
    own.  Each mesh dim follows w's split there.  Where w splits its
    columns, x is whole on that dim and the output is split by columns
    (column-parallel); where w splits its rows, x is split in K alike and
    the output is a partial sum (row-parallel), reduced back to x's split
    where x's rows were split on that dim (a resident layout's activation
    sum, as at decode); where w is whole, x keeps the sharding of its
    leading dims and the output has it.  ``reduced``: a partial-sum
    output is reduced, split along its last dim, for a product that a
    nonlinearity follows.  The backward states its partial sums: x's
    gradient where w's columns are split, w's where x's rows are.  A
    plain ``x @ w`` without a DTensor."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    last = x.ndim - 1
    x_pl, w_pl, out, x_grad, w_grad, back = [], [], [], [], [], []
    for q, r in zip(x.placements, w.placements):
        rows = isinstance(q, Shard) and q.dim != last
        if isinstance(r, Shard) and r.dim == 1:          # w's columns
            x_pl.append(Replicate())
            w_pl.append(Shard(1))
            out.append(Shard(last))
            x_grad.append(Partial())
            w_grad.append(Shard(1))
        elif isinstance(r, Shard) and r.dim == 0:        # w's rows
            x_pl.append(Shard(last))
            w_pl.append(Shard(0))
            out.append(Partial())
            x_grad.append(Shard(last))
            w_grad.append(Shard(0))
        else:                                            # w whole
            x_pl.append(q if rows else Replicate())
            w_pl.append(Replicate())
            out.append(x_pl[-1])
            x_grad.append(x_pl[-1])
            w_grad.append(Partial() if rows else Replicate())
        if isinstance(out[-1], Partial):
            back.append(q if rows else Shard(last) if reduced else out[-1])
        else:
            back.append(out[-1])
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad)
    wl = w.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    y = wrap_local(xl @ wl, mesh, out, (*x.shape[:-1], w.shape[1]))
    return y if back == out else y.redistribute(mesh, back)


def wrap_local(local, mesh, placements, shape):
    """The DTensor of global ``shape`` laid out by ``placements`` whose
    block on this rank is ``local``.  Its gradient comes back laid out by
    the placements, a partial sum's taken whole, on every torch version
    (``DTensor.from_local``'s gradient for a partial sum differs between
    versions, and 2.11 takes no ``grad_placements``)."""
    return _WrapLocal.apply(local.contiguous(), mesh, list(placements),
                            tuple(shape))


class _WrapLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, placements, shape):
        from torch.distributed.tensor import DTensor, Replicate
        ctx.mesh = mesh
        ctx.grad = [Replicate() if q.is_partial() else q for q in placements]
        return DTensor.from_local(
            local, mesh, placements, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.grad).to_local(), None, \
            None, None


def row_parallel_head(x, w):
    """``x @ w`` for activations x [B, S, K] and a weight ``w`` [K, N]
    taken whole (an LM head: N is the vocabulary).  On DTensors one
    block a rank: x keeps its batch sharding and splits its sequence over
    the mesh dims that do not shard it (where they divide it), so each
    rank multiplies its own rows by the whole weight and the output,
    split as x's rows, is whole along N (a softmax over N stays local).
    In the backward w's gradient is a partial sum over the mesh dims that
    split x's rows.  A plain ``x @ w`` without a DTensor."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    batch = [isinstance(q, Shard) and q.dim == 0 for q in x.placements]
    seq, split = x.shape[1], 1
    x_pl = []
    for i, b in enumerate(batch):
        if b:
            x_pl.append(Shard(0))
        elif seq % (split * mesh.size(i)) == 0:
            split *= mesh.size(i)
            x_pl.append(Shard(1))
        else:
            x_pl.append(Replicate())
    xl = x.redistribute(mesh, x_pl).to_local()
    wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(q, Shard) else q
                         for q in x_pl])
    return wrap_local(xl @ wl, mesh, x_pl, (*x.shape[:-1], w.shape[1]))


def per_batch_shard(call, batched: tuple, rest: tuple = ()):
    """``call(*batched, *rest)`` one batch block a rank, for a function
    that is independent over dim 0 of every ``batched`` tensor (a scan
    over the sequence, a chunked recurrence): the DTensors among
    ``batched`` keep the first one's batch sharding and are made whole
    in every other dim, the DTensors among ``rest`` are made whole, and
    ``call`` runs on the local blocks.  Its outputs (a tensor or a
    tuple) come back as DTensors with that batch sharding; the gradient
    of a ``rest`` DTensor is a partial sum over the mesh dims that split
    the batch.  Without a DTensor this is ``call(*batched, *rest)``."""
    lead = next((t for t in batched if is_dtensor(t)), None)
    if lead is None:
        return call(*batched, *rest)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = lead.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in lead.placements]
    whole = [Replicate()] * mesh.ndim
    summed = [Partial() if isinstance(p, Shard) else p for p in rows]

    def local(t, placements, grads):
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grads) if is_dtensor(t) else t
    out = call(*(local(t, rows, rows) for t in batched),
               *(local(t, whole, summed) for t in rest))

    def back(o):
        return wrap_local(o, mesh, rows, (lead.shape[0], *o.shape[1:]))
    return tuple(back(o) for o in out) if isinstance(out, tuple) \
        else back(out)


def constrain_batch_activations(x, parallel: Optional[ParallelConfig], *,
                                batch_size: Optional[int] = None):
    """Pin [B, S, D] activations to batch-over-(pod,)data (+ the sequence
    over model with ``seq_shard``): a ``redistribute`` of a DTensor.  A
    no-op on a plain tensor, without ``axis_sizes``, or where the batch
    does not divide."""
    if parallel is None or not parallel.axis_sizes or not is_dtensor(x):
        return x
    b = batch_size if batch_size is not None else x.shape[0]
    axes = parallel.batch_axes()
    prod = 1
    for a in axes:
        prod *= max(1, parallel.size_of(a))
    if prod <= 1 or b % prod != 0:
        return x
    spec = [axes if len(axes) > 1 else axes[0]] + [None] * (x.ndim - 1)
    if parallel.seq_shard and x.ndim >= 3:
        spec[1] = parallel.model_axis
    return x.redistribute(x.device_mesh,
                          to_placements(_trim(spec), x.device_mesh))


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
