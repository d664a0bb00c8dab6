"""The sharded filter: routed lookups and writes over filter shards.

Counterpart of ``repro.core.distributed``.  Filter shards lie along one
mesh axis; lookups AND writes are routed:

    owner = H(key) mod n_shards          (or the pair owner, route="pair")
    a capacity-bounded exchange sends each key to its owner shard,
    the owner runs the shard-local op (probe / insert / delete) on its table,
    a second exchange returns the answers.

**One controller, shards on one device.**  The reference drives a JAX mesh
from one process; the port keeps that API (``mesh, axis, state`` in every
call) with a ``ShardMesh``: a shard count, the axis name and one
``torch.device``.  A ``ShardedFilterState`` stacks every shard's table
(int32[S, buffer, bucket_size]) and stash (int32[S, 2, slots]) on that
device.  The exchange is ``_all_to_all``, a transpose of the send buffers
``[S_src, S_dst, cap]`` into ``[S_dst, S_src, cap]``: the one place to
change when shards spread over several cards.  Each shard's received
buffer runs through ``FilterOps``' raw-table ops (``probe_table``,
``insert_table``, ``delete_table``), one call a shard.

**Routing** ranks every source shard's lanes in one ``conflict_waves``
call, keyed by ``source * S + owner`` so ranks stay per source as in the
reference's per-shard body; lane i claims slot ``rank[i]`` of its owner's
row, and ``rank >= cap`` is the routing overflow.  Lookups answer
overflowed keys "maybe present"; writes return them as a **deferred**
batch (never attempted: resubmit), and ``overflow`` counts them per source
shard.

Inputs are int32 key halves ``[S * per_shard]`` in shard order (shard s
holds lanes ``s * per_shard ...``), as the reference shards a batch over
its axis.  Every call runs on the mesh's device and refuses a state that
lies elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import hashing
from repro_torch.core.filter import FilterState
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.scheduling import conflict_waves
from repro_torch.kernels.stash import DEFAULT_STASH_SLOTS


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``n_shards`` filter shards along ``axis_name`` on one device.

    ``mesh.shape[axis] == n_shards``, as for a JAX mesh.  Build it with
    ``distributed.elastic.filter_mesh``.
    """

    n_shards: int
    axis_name: str = "data"
    device: torch.device = torch.device("cuda")

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.n_shards}


class ShardedFilterState(NamedTuple):
    """Per-shard filter data plane, stacked along the shard axis.

    ``tables``: int32[n_shards, buffer_buckets, bucket_size] (0 == EMPTY).
    ``stashes``: int32[n_shards, 2, stash_slots] overflow stashes, or None
    (exhausted chains then fail).  ``n_buckets``: the shards' ACTIVE bucket
    count as a host int, or None for "the full buffer".
    """
    tables: torch.Tensor
    stashes: Optional[torch.Tensor] = None
    n_buckets: Optional[int] = None


def make_sharded_state(n_shards: int, n_buckets: int, bucket_size: int = 4,
                       *, stash_slots: int = DEFAULT_STASH_SLOTS,
                       buffer_buckets: Optional[int] = None,
                       device="cuda") -> ShardedFilterState:
    """Fresh sharded state on ``device``: zero tables and per-shard stashes
    (``stash_slots=0``: none).  Raises if ``"cuda"`` has no card."""
    dev = hashing.resolve_device(device)
    buf = buffer_buckets or n_buckets
    if buf < n_buckets:
        raise ValueError(f"buffer_buckets={buf} < n_buckets={n_buckets}")
    return ShardedFilterState(
        tables=torch.zeros((n_shards, buf, bucket_size), dtype=torch.int32,
                           device=dev),
        stashes=(torch.zeros((n_shards, 2, stash_slots), dtype=torch.int32,
                             device=dev) if stash_slots else None),
        n_buckets=n_buckets)


def sharded_occupancy(state: ShardedFilterState) -> torch.Tensor:
    """Aggregate load factor (live table slots and stash entries over table
    capacity) -> float32 0-dim tensor."""
    live = (state.tables != 0).sum()
    if state.stashes is not None:
        live = live + (state.stashes[:, 0, :] != 0).sum()
    return live.to(torch.float32) / float(state.tables.numel())


def _route_nb(state: ShardedFilterState) -> int:
    return (state.n_buckets if state.n_buckets is not None
            else state.tables.shape[1])


def _capacity(per_shard: int, capacity_factor: float, n_shards: int) -> int:
    """Slots per (source, destination) pair: the reference's formula."""
    return int(per_shard * capacity_factor / n_shards + 1)


def _on_mesh(mesh: ShardMesh, state: ShardedFilterState, hi, lo, valid=None):
    """Check the state lies on the mesh's device; bring the lanes there."""
    dev = mesh.device
    for name, t in (("tables", state.tables), ("stashes", state.stashes)):
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"sharded state {name} lie on {t.device}, the "
                             f"mesh on {dev}")
    hi, lo = hi.to(dev), lo.to(dev)
    return hi, lo, None if valid is None else valid.to(dev)


def _route(hi, lo, n_shards: int, cap: int, valid=None, *,
           route: str = "key", n_buckets: Optional[int] = None,
           fp_bits: Optional[int] = None):
    """Owner routing of every source shard's lanes ([S, P] each).

    Returns (dst int64[S, P] — owner, or n_shards for overflow; rank
    int64[S, P] — the claimed slot in the owner's row, ranked among the
    same source's earlier lanes; fits bool[S, P]).  Invalid lanes claim no
    slot and never fit.  ``route="pair"`` hashes the key's candidate pair
    (what elastic resharding needs); ``"key"`` the raw key.
    """
    if route == "pair":
        owner = hashing.owner_shard_key_pair(hi, lo, n_buckets, fp_bits,
                                             n_shards)
    elif route == "key":
        owner = hashing.owner_shard(hi, lo, n_shards)
    else:
        raise ValueError(f"unknown route {route!r} (expected 'key' | "
                         "'pair')")
    if valid is None:
        valid = torch.ones(owner.shape, dtype=torch.bool, device=hi.device)
    src = torch.arange(owner.shape[0], device=hi.device)[:, None]
    rank = conflict_waves((src * n_shards + owner).reshape(-1),
                          valid.reshape(-1)).reshape(owner.shape)
    fits = (rank < cap) & valid
    dst = torch.where(fits, owner, n_shards)
    return dst, rank, fits


def _scatter_routed(dst, rank, fits, n_shards: int, cap: int, *lanes):
    """[S, P] lanes -> capacity-bounded send buffers [S_src, S_dst, cap]
    (zeros where no lane landed) plus their valid mask.  No host sync:
    lanes that do not fit write one dump slot past the buffers."""
    s_src = dst.shape[0]
    src = torch.arange(s_src, device=dst.device)[:, None]
    size = s_src * n_shards * cap
    where = torch.where(fits, (src * n_shards + dst) * cap + rank, size)
    where = where.reshape(-1)
    out = []
    for x in (*lanes, fits):
        buf = torch.zeros((size + 1,), dtype=x.dtype, device=x.device)
        buf.scatter_(0, where, x.reshape(-1))
        out.append(buf[:size].reshape(s_src, n_shards, cap))
    return out


def _all_to_all(buf: torch.Tensor) -> torch.Tensor:
    """The exchange: [S_src, S_dst, ...] -> [S_dst, S_src, ...] (row s of
    shard d's buffer holds what shard s sent it)."""
    return buf.transpose(0, 1).contiguous()


def _gather_back(back, dst, rank, n_shards: int):
    """Answers [S_src, S_dst, cap] -> each source lane's own answer."""
    src = torch.arange(dst.shape[0], device=dst.device)[:, None]
    cap = back.shape[2]
    return back[src, dst.clamp(0, n_shards - 1), rank.clamp(0, cap - 1)]


def distributed_lookup(mesh: ShardMesh, axis: str, state: ShardedFilterState,
                       hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                       capacity_factor: float = 2.0, backend: str = "auto",
                       route: str = "key"):
    """Batched membership across filter shards -> (hits bool[N], overflow
    int64[n_shards]).

    Overflowed keys answer True ("maybe"); ``overflow`` counts them per
    source shard.  Stashes answer in the same probe.  ``route`` must be the
    one the state was written with.
    """
    n_shards = mesh.shape[axis]
    hi, lo, _ = _on_mesh(mesh, state, hi, lo)
    per_shard = hi.shape[0] // n_shards
    cap = _capacity(per_shard, capacity_factor, n_shards)
    fops = FilterOps(fp_bits=fp_bits, backend=backend)
    hi, lo = hi.reshape(n_shards, per_shard), lo.reshape(n_shards, per_shard)
    dst, rank, fits = _route(hi, lo, n_shards, cap, route=route,
                             n_buckets=_route_nb(state), fp_bits=fp_bits)
    overflow = (~fits).sum(dim=1)
    r_hi, r_lo, r_valid = (_all_to_all(b) for b in _scatter_routed(
        dst, rank, fits, n_shards, cap, hi, lo))
    hit = torch.stack([
        fops.probe_table(state.tables[d], r_hi[d].reshape(-1),
                         r_lo[d].reshape(-1), n_buckets=state.n_buckets,
                         stash=(None if state.stashes is None
                                else state.stashes[d])
                         ).reshape(n_shards, cap)
        for d in range(n_shards)]) & r_valid
    back = _all_to_all(hit)
    ans = torch.where(fits, _gather_back(back, dst, rank, n_shards), True)
    return ans.reshape(-1), overflow


def _distributed_write(op: str, mesh: ShardMesh, axis: str,
                       state: ShardedFilterState, hi, lo, *, fops: FilterOps,
                       capacity_factor: float, donate: bool, valid=None,
                       route: str = "key"):
    n_shards = mesh.shape[axis]
    hi, lo, valid = _on_mesh(mesh, state, hi, lo, valid)
    per_shard = hi.shape[0] // n_shards
    cap = _capacity(per_shard, capacity_factor, n_shards)
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    shape = (n_shards, per_shard)
    hi, lo, valid = hi.reshape(shape), lo.reshape(shape), valid.reshape(shape)
    dst, rank, fits = _route(hi, lo, n_shards, cap, valid, route=route,
                             n_buckets=_route_nb(state),
                             fp_bits=fops.fp_bits)
    overflow = (~fits & valid).sum(dim=1)
    r_hi, r_lo, r_valid = (_all_to_all(b) for b in _scatter_routed(
        dst, rank, fits, n_shards, cap, hi, lo))
    tables = state.tables if donate else state.tables.clone()
    stashes = state.stashes
    if stashes is not None and not donate:
        stashes = stashes.clone()
    run = fops.insert_table if op == "insert" else fops.delete_table
    oks = []
    for d in range(n_shards):
        out = run(tables[d], r_hi[d].reshape(-1), r_lo[d].reshape(-1),
                  n_buckets=state.n_buckets, valid=r_valid[d].reshape(-1),
                  stash=None if stashes is None else stashes[d])
        tables[d].copy_(out[0])
        if stashes is not None:
            stashes[d].copy_(out[1])
        oks.append(out[-1].reshape(n_shards, cap))
    back = _all_to_all(torch.stack(oks) & r_valid)
    ok = fits & _gather_back(back, dst, rank, n_shards)
    deferred = ~fits & valid            # never attempted: resubmit
    new_state = state._replace(tables=tables, stashes=stashes)
    return new_state, ok.reshape(-1), deferred.reshape(-1), overflow


def distributed_insert(mesh: ShardMesh, axis: str, state: ShardedFilterState,
                       hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                       capacity_factor: float = 2.0, backend: str = "auto",
                       evict_rounds: Optional[int] = None,
                       max_disp: int = 500, schedule: bool = True,
                       donate: bool = False, valid=None, route: str = "key"):
    """Routed bulk insert across filter shards
    -> (new_state, ok bool[N], deferred bool[N], overflow int64[S]).

    ``ok``: the key is resident (table or stash) on its owner shard;
    ``deferred``: the lane exceeded its owner's capacity and was never
    attempted (resubmit it); ``ok=False`` without ``deferred`` is a real
    failure (chain budget and stash exhausted).  ``evict_rounds`` bounds
    the kernel backend's eviction rounds, ``max_disp`` the scan backend's
    chains.  ``valid=False`` lanes are never routed, attempted or deferred.
    ``donate=True`` updates the state's tensors in place.
    """
    fops = FilterOps(fp_bits=fp_bits, backend=backend,
                     evict_rounds=evict_rounds, max_disp=max_disp,
                     schedule=schedule)
    return _distributed_write("insert", mesh, axis, state, hi, lo, fops=fops,
                              capacity_factor=capacity_factor, donate=donate,
                              valid=valid, route=route)


def distributed_delete(mesh: ShardMesh, axis: str, state: ShardedFilterState,
                       hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                       capacity_factor: float = 2.0, backend: str = "auto",
                       donate: bool = False, valid=None, route: str = "key"):
    """Routed verified delete across filter shards; the same return
    contract as ``distributed_insert``.  Lanes that miss a table clear
    their shard's stash entry.  Callers verify membership first."""
    fops = FilterOps(fp_bits=fp_bits, backend=backend)
    return _distributed_write("delete", mesh, axis, state, hi, lo, fops=fops,
                              capacity_factor=capacity_factor, donate=donate,
                              valid=valid, route=route)


# ------------------------------------------------- control-plane shims --


def local_shard_insert_host(state: ShardedFilterState, shard: int, table
                            ) -> ShardedFilterState:
    """Swap one shard's table (control plane: after a per-shard rebuild)."""
    tables = state.tables.clone()
    tables[shard] = table.to(tables.device)
    return state._replace(tables=tables)


def local_shard_delete_host(state: ShardedFilterState, shard: int,
                            hi: torch.Tensor, lo: torch.Tensor, *,
                            fp_bits: int, backend: str = "auto",
                            n_buckets=None
                            ) -> tuple[ShardedFilterState, torch.Tensor]:
    """Verified delete on one shard (control plane) -> (state, deleted).

    ``n_buckets`` defaults to the state's ACTIVE count, else the buffer's
    rows."""
    table = state.tables[shard]
    if n_buckets is None:
        n_buckets = _route_nb(state)
    st = FilterState(table, torch.zeros((), dtype=torch.int64,
                                        device=table.device), int(n_buckets))
    st, ok = FilterOps(fp_bits=fp_bits, backend=backend).delete(st, hi, lo)
    return local_shard_insert_host(state, shard, st.table), ok


def replicated_lookup(tables: torch.Tensor, hi: torch.Tensor,
                      lo: torch.Tensor, *, fp_bits: int,
                      backend: str = "auto") -> torch.Tensor:
    """Probe every shard (broadcast query: "is this key anywhere?")."""
    fops = FilterOps(fp_bits=fp_bits, backend=backend)
    hit = torch.zeros(hi.shape, dtype=torch.bool, device=tables.device)
    for t in tables:
        hit |= fops.probe_table(t, hi, lo)
    return hit
