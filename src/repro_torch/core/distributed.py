"""The sharded filter: routed lookups and writes over filter shards.

Counterpart of ``repro.core.distributed``.  Filter shards lie along one
mesh axis; lookups AND writes are routed:

    owner = H(key) mod n_shards          (or the pair owner, route="pair")
    a capacity-bounded exchange sends each key to its owner shard,
    the owner runs the shard-local op (probe / insert / delete) on its table,
    a second exchange returns the answers.

**One controller, shards in parts.**  The reference drives a JAX mesh from
one process, one shard a device; the port keeps that API (``mesh, axis,
state`` in every call) with a ``ShardMesh``: a shard count, the axis name
and its *parts*.  A part is one device and the run of shards on it, in
mesh order.  ``filter_mesh(n, devices=[...])`` lays one part a shard on
``devices[s]`` (the reference's layout; a device may repeat, which is how
the CPU and a single card reach this path); ``filter_mesh(n, device=d)``
one part holding every shard.  A ``ShardedFilterState`` holds, for each
part, one stacked table tensor (int32[n_p, buffer, bucket_size]) and one
stacked stash tensor (int32[n_p, 2, slots]) on the part's device; the
shard accessors (``table(s)``, ``stash(s)``, ``stacked(device)``) hide the
parts from host code.

**The exchange** is ``_exchange``: each source part packs its lanes into
one int32 send buffer ``[S_dst, n_src, fields, cap]`` (the key halves, or
the fingerprint and bucket, and the valid mask), and destination part q
concatenates rows ``q`` of every source part's buffer, each slice copied
to q's device without a host wait: one copy a pair of parts a step.  On a
one-part mesh the receive buffer is the send buffer (the transpose the
reference's ``all_to_all`` is on one device).  Answers go back the same
way and gather on the caller's device.  Each shard's received lanes run
through ``FilterOps``' raw-table ops (``probe_table``, ``insert_table``,
``delete_table``) on its part's device, one call a shard, every part's
calls issued before anything is read back, so the cards work at once.

**Routing** ranks each source part's lanes in one ``conflict_waves``
call, keyed by ``source * S + owner`` so ranks stay per source as in the
reference's per-shard body; lane i claims slot ``rank[i]`` of its owner's
row, and ``rank >= cap`` is the routing overflow.  Lookups answer
overflowed keys "maybe present"; writes return them as a **deferred**
batch (never attempted: resubmit), and ``overflow`` counts them per source
shard.

Inputs are int32 key halves ``[S * per_shard]`` in shard order (shard s
holds lanes ``s * per_shard ...``), as the reference shards a batch over
its axis, on any device: each source part's lanes move to its device, and
the answers come back on the inputs' device.  Every call refuses a state
that is not laid out as its mesh is.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import hashing
from repro_torch.core.filter import FilterState
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.scheduling import conflict_waves
from repro_torch.kernels.stash import DEFAULT_STASH_SLOTS

# Copies between two devices made by the exchanges (and the answers'
# gathers): "copies" and "bytes".  ``reset_exchange_counts`` zeroes them.
EXCHANGE: collections.Counter = collections.Counter()


def reset_exchange_counts() -> None:
    EXCHANGE.clear()


def _spans(parts) -> list:
    """((device, count), ...) -> [(device, first shard, end shard), ...]."""
    out, a = [], 0
    for dev, n in parts:
        out.append((dev, a, a + n))
        a += n
    return out


def _card(device) -> torch.device:
    """A mesh device: resolved (raises rather than fall back) and, for a
    card, with its index, so that it compares equal to its tensors'."""
    dev = hashing.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_layout(n_shards: int, *, device="cuda",
                 devices: Optional[Sequence] = None) -> tuple:
    """The parts ``((device, count), ...)`` of ``n_shards`` shards: one
    part a shard on ``devices[s]`` (the first ``n_shards`` of them; fewer
    raise), or without ``devices`` one part on ``device``."""
    if n_shards < 1:
        raise ValueError(f"a filter mesh needs a shard, got {n_shards}")
    if devices is None:
        return ((_card(device), int(n_shards)),)
    devices = list(devices)
    if len(devices) < n_shards:
        raise RuntimeError(f"{len(devices)} devices cannot host {n_shards} "
                           "filter shards")
    return tuple((_card(d), 1) for d in devices[:n_shards])


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``n_shards`` filter shards along ``axis_name``, laid out in
    ``parts``: ``((device, count), ...)``, the counts summing to
    ``n_shards``; shard s lies on ``devices[s]``.

    ``mesh.shape[axis] == n_shards``, as for a JAX mesh.  Build it with
    ``distributed.elastic.filter_mesh``.
    """

    n_shards: int
    axis_name: str
    parts: tuple

    def __post_init__(self):
        counts = [n for _d, n in self.parts]
        if not counts or min(counts) < 1 or sum(counts) != self.n_shards:
            raise ValueError(f"parts {self.parts} do not hold "
                             f"{self.n_shards} shards")

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.n_shards}

    @property
    def devices(self) -> tuple:
        """Shard s's device, for every s."""
        return tuple(d for d, n in self.parts for _ in range(n))

    def spans(self) -> list:
        """(device, first shard, end shard) of each part."""
        return _spans(self.parts)


class ShardedFilterState(NamedTuple):
    """Per-shard filter data plane, one stacked tensor a part.

    ``table_parts``: for each part, int32[n_p, buffer_buckets, bucket_size]
    (0 == EMPTY) on the part's device.  ``stash_parts``: for each part,
    int32[n_p, 2, stash_slots] overflow stashes there, or None (exhausted
    chains then fail).  ``n_buckets``: the shards' ACTIVE bucket count as a
    host int, or None for "the full buffer".
    """
    table_parts: tuple
    stash_parts: Optional[tuple] = None
    n_buckets: Optional[int] = None

    @property
    def parts(self) -> tuple:
        """((device, count), ...): the layout, as a mesh's ``parts``."""
        return tuple((t.device, t.shape[0]) for t in self.table_parts)

    @property
    def n_shards(self) -> int:
        return sum(t.shape[0] for t in self.table_parts)

    @property
    def devices(self) -> tuple:
        return tuple(d for d, n in self.parts for _ in range(n))

    def _locate(self, shard: int) -> tuple[int, int]:
        for p, (_dev, a, b) in enumerate(_spans(self.parts)):
            if a <= shard < b:
                return p, shard - a
        raise IndexError(f"shard {shard} of {self.n_shards}")

    def table(self, shard: int) -> torch.Tensor:
        """Shard ``shard``'s table, a view on its device."""
        p, i = self._locate(shard)
        return self.table_parts[p][i]

    def stash(self, shard: int) -> Optional[torch.Tensor]:
        """Shard ``shard``'s stash, a view on its device (None without)."""
        if self.stash_parts is None:
            return None
        p, i = self._locate(shard)
        return self.stash_parts[p][i]

    def stacked(self, device=None):
        """(tables int32[S, buffer, b], stashes int32[S, 2, slots] or None)
        on ``device`` (default: shard 0's), for host paths (checkpoints,
        checks).  A one-part state's tensors come back as they are where
        they already lie there: do not write to them."""
        dev = (self.table_parts[0].device if device is None
               else torch.device(device))

        def cat(parts):
            if parts is None:
                return None
            if len(parts) == 1:
                return parts[0].to(dev)
            return torch.cat([p.to(dev) for p in parts])
        return cat(self.table_parts), cat(self.stash_parts)


def place_shards(parts, tables, stashes=None, n_buckets=None
                 ) -> ShardedFilterState:
    """Shards on any devices -> a state laid out in ``parts``.

    ``tables`` (and ``stashes``) is a stacked [S, ...] tensor or a sequence
    of one tensor a shard; part p stacks its run of shards on its device.
    A stacked tensor's slice already on its part's device is taken as it
    is, not copied."""
    def lay(x):
        if x is None:
            return None
        out = []
        for dev, a, b in _spans(parts):
            if isinstance(x, torch.Tensor):
                out.append(x[a:b].to(dev))
            else:
                out.append(torch.stack([t.to(dev) for t in x[a:b]]))
        return tuple(out)
    n = tables.shape[0] if isinstance(tables, torch.Tensor) else len(tables)
    if n != sum(c for _d, c in parts):
        raise ValueError(f"{n} shards for parts {parts}")
    return ShardedFilterState(lay(tables), lay(stashes), n_buckets)


def lay_out(mesh: ShardMesh, state: ShardedFilterState) -> ShardedFilterState:
    """``state`` laid out as ``mesh`` is (each shard moved to its mesh
    device, the parts regrouped); a state laid out so already comes back as
    it is."""
    if state.parts == mesh.parts and (
            state.stash_parts is None
            or tuple((t.device, t.shape[0]) for t in state.stash_parts)
            == mesh.parts):
        return state
    n = state.n_shards
    return place_shards(
        mesh.parts, [state.table(s) for s in range(n)],
        None if state.stash_parts is None
        else [state.stash(s) for s in range(n)], state.n_buckets)


def make_sharded_state(n_shards: int, n_buckets: int, bucket_size: int = 4,
                       *, stash_slots: int = DEFAULT_STASH_SLOTS,
                       buffer_buckets: Optional[int] = None,
                       device="cuda", mesh: Optional[ShardMesh] = None,
                       devices: Optional[Sequence] = None
                       ) -> ShardedFilterState:
    """Fresh sharded state: zero tables and per-shard stashes
    (``stash_slots=0``: none), laid out as ``mesh`` is, or one part a
    shard on ``devices``, or one part on ``device``.  Raises if a card it
    names is missing."""
    parts = (mesh.parts if mesh is not None
             else shard_layout(n_shards, device=device, devices=devices))
    if sum(c for _d, c in parts) != n_shards:
        raise ValueError(f"a mesh of {sum(c for _d, c in parts)} shards "
                         f"for {n_shards}")
    buf = buffer_buckets or n_buckets
    if buf < n_buckets:
        raise ValueError(f"buffer_buckets={buf} < n_buckets={n_buckets}")
    return ShardedFilterState(
        table_parts=tuple(torch.zeros((n, buf, bucket_size),
                                      dtype=torch.int32, device=d)
                          for d, n in parts),
        stash_parts=(tuple(torch.zeros((n, 2, stash_slots),
                                       dtype=torch.int32, device=d)
                           for d, n in parts) if stash_slots else None),
        n_buckets=n_buckets)


def sharded_occupancy(state: ShardedFilterState) -> torch.Tensor:
    """Aggregate load factor (live table slots and stash entries over table
    capacity) -> float32 0-dim tensor on shard 0's device."""
    dev = state.table_parts[0].device
    live = sum((t != 0).sum().to(dev) for t in state.table_parts)
    if state.stash_parts is not None:
        live = live + sum((s[:, 0, :] != 0).sum().to(dev)
                          for s in state.stash_parts)
    cells = sum(t.numel() for t in state.table_parts)
    return live.to(torch.float32) / float(cells)


def _route_nb(state: ShardedFilterState) -> int:
    return (state.n_buckets if state.n_buckets is not None
            else state.table_parts[0].shape[1])


def _capacity(per_shard: int, capacity_factor: float, n_shards: int) -> int:
    """Slots per (source, destination) pair: the reference's formula."""
    return int(per_shard * capacity_factor / n_shards + 1)


def _on_mesh(mesh: ShardMesh, state: ShardedFilterState) -> None:
    """Refuse a state not laid out as the mesh is: the same shards, each on
    the mesh's device for it (index included), in the same parts."""
    for name, parts in (("tables", state.table_parts),
                        ("stashes", state.stash_parts)):
        if parts is None:
            continue
        layout = tuple((t.device, t.shape[0]) for t in parts)
        devs = [d for d, n in layout for _ in range(n)]
        if len(devs) != mesh.n_shards:
            raise ValueError(f"sharded state {name} hold {len(devs)} "
                             f"shards, the mesh {mesh.n_shards}")
        for s, (got, want) in enumerate(zip(devs, mesh.devices)):
            if got != want:
                raise ValueError(f"sharded state {name} of shard {s} lie on "
                                 f"{got}, the mesh's shard {s} on {want}")
        if layout != mesh.parts:
            raise ValueError(f"sharded state {name} lie in parts of "
                             f"{[n for _d, n in layout]} shards, the mesh's "
                             f"in {[n for _d, n in mesh.parts]}")


def _move(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``.  A copy to a card does not wait for the host (a
    copy between two cards orders both cards' current streams); a copy
    between two devices is counted in ``EXCHANGE``."""
    if x.device == dev:
        return x
    if x.device.type == "cuda" and dev.type == "cuda":
        EXCHANGE["copies"] += 1
        EXCHANGE["bytes"] += x.numel() * x.element_size()
    return x.to(dev, non_blocking=dev.type == "cuda")


def _lanes(x: torch.Tensor, dev, a: int, b: int, per_shard: int):
    """Source shards a..b-1's lanes of ``x`` [S * per_shard] on ``dev``
    -> [b - a, per_shard]."""
    return _move(x[a * per_shard:b * per_shard], dev).reshape(b - a,
                                                               per_shard)


def _home(xs: list, home: torch.device) -> torch.Tensor:
    """Each part's [n_p, ...] rows, in mesh order, on the caller's
    device."""
    if len(xs) == 1:
        return _move(xs[0], home)
    return torch.cat([_move(x, home) for x in xs])


def _route(hi, lo, n_shards: int, cap: int, valid=None, *,
           route: str = "key", n_buckets: Optional[int] = None,
           fp_bits: Optional[int] = None):
    """Owner routing of a part's source shards' lanes ([n_p, P] each).

    Returns (dst int64[n_p, P] — owner, or n_shards for overflow; rank
    int64[n_p, P] — the claimed slot in the owner's row, ranked among the
    same source's earlier lanes; fits bool[n_p, P]).  Invalid lanes claim
    no slot and never fit.  ``route="pair"`` hashes the key's candidate
    pair (what elastic resharding needs); ``"key"`` the raw key.
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


def _pack_routed(dst, rank, fits, n_shards: int, cap: int, *lanes):
    """A part's [n_src, P] lanes -> its send buffer int32[S_dst, n_src,
    len(lanes) + 1, cap]: each lane's fields at its claimed slot, the last
    field the valid mask, zeros where no lane landed.  No host sync: lanes
    that do not fit write one dump slot past the buffer."""
    n_src = dst.shape[0]
    f = len(lanes) + 1
    src = torch.arange(n_src, device=dst.device)[:, None]
    size = n_shards * n_src * f * cap
    base = torch.where(fits, (dst * n_src + src) * (f * cap) + rank, size)
    base = base.reshape(-1)
    buf = torch.zeros((size + 1,), dtype=torch.int32, device=dst.device)
    for k, x in enumerate((*lanes, fits)):
        where = base if k == 0 else torch.where(base < size,
                                                base + k * cap, size)
        buf.scatter_(0, where, x.reshape(-1).to(torch.int32))
    return buf[:size].reshape(n_shards, n_src, f, cap)


def _exchange(bufs: list, mesh: ShardMesh) -> list:
    """The exchange: each part's buffer [S_dst, n_src, ...] -> each part's
    receive buffer [n_dst, S_src, ...], where row s of shard d's buffer
    holds what shard s sent it.  Destination part q takes rows a_q..b_q of
    every source part's buffer on its device, in mesh order."""
    out = []
    for dev, a, b in mesh.spans():
        pieces = [_move(buf[a:b], dev) for buf in bufs]
        out.append(pieces[0] if len(pieces) == 1
                   else torch.cat(pieces, dim=1))
    return out


def _fields(recv: torch.Tensor) -> list:
    """A receive buffer [n_q, S_src, F, cap] -> its F fields, each a
    contiguous [n_q, S_src * cap] (the last, the valid mask, as bool): a
    shard's row is a kernel's input."""
    n_q, f = recv.shape[0], recv.shape[2]
    out = [recv[:, :, k].contiguous().reshape(n_q, -1) for k in range(f)]
    out[-1] = out[-1] != 0
    return out


def _gather_back(back, dst, rank, n_shards: int):
    """Answers [n_src, S_dst, cap] -> each source lane's own answer."""
    src = torch.arange(dst.shape[0], device=dst.device)[:, None]
    cap = back.shape[2]
    return back[src, dst.clamp(0, n_shards - 1), rank.clamp(0, cap - 1)]


def _routed_out(mesh, hi, lo, valid, per_shard: int, cap: int, *,
                route: str, n_buckets: int, fp_bits: int):
    """Route every source part's lanes on its device and exchange them
    -> (routes [(dst, rank, fits, valid)] a source part, receive buffers
    a destination part)."""
    n_shards = mesh.n_shards
    routes, sends = [], []
    for dev, a, b in mesh.spans():
        h, l = (_lanes(x, dev, a, b, per_shard) for x in (hi, lo))
        v = None if valid is None else _lanes(valid, dev, a, b, per_shard)
        dst, rank, fits = _route(h, l, n_shards, cap, v, route=route,
                                 n_buckets=n_buckets, fp_bits=fp_bits)
        routes.append((dst, rank, fits, v))
        sends.append(_pack_routed(dst, rank, fits, n_shards, cap, h, l))
    return routes, _exchange(sends, mesh)


def _answers_back(mesh, answers: list, routes: list) -> list:
    """Each destination part's answers [n_dst, S_src, cap] -> each source
    lane's answer, [n_src, P] a source part (unfit lanes: False)."""
    backs = [a.transpose(0, 1).contiguous() for a in answers]
    return [fits & _gather_back(back, dst, rank, mesh.n_shards)
            for (dst, rank, fits, _v), back in zip(routes,
                                                   _exchange(backs, mesh))]


def distributed_lookup(mesh: ShardMesh, axis: str, state: ShardedFilterState,
                       hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                       capacity_factor: float = 2.0, backend: str = "auto",
                       route: str = "key"):
    """Batched membership across filter shards -> (hits bool[N], overflow
    int64[n_shards]) on ``hi``'s device.

    Overflowed keys answer True ("maybe"); ``overflow`` counts them per
    source shard.  Stashes answer in the same probe.  ``route`` must be the
    one the state was written with.
    """
    n_shards = mesh.shape[axis]
    _on_mesh(mesh, state)
    per_shard = hi.shape[0] // n_shards
    cap = _capacity(per_shard, capacity_factor, n_shards)
    fops = FilterOps(fp_bits=fp_bits, backend=backend)
    routes, recvs = _routed_out(mesh, hi, lo, None, per_shard, cap,
                                route=route, n_buckets=_route_nb(state),
                                fp_bits=fp_bits)
    answers = []
    for q, recv in enumerate(recvs):
        r_hi, r_lo, r_valid = _fields(recv)
        tables = state.table_parts[q]
        stashes = state.stash_parts
        answers.append(torch.stack([
            fops.probe_table(tables[i], r_hi[i], r_lo[i],
                             n_buckets=state.n_buckets,
                             stash=None if stashes is None
                             else stashes[q][i])
            for i in range(tables.shape[0])]).reshape(recv.shape[0],
                                                      n_shards, cap)
            & r_valid.reshape(recv.shape[0], n_shards, cap))
    got = _answers_back(mesh, answers, routes)
    ans = [torch.where(fits, g, True)
           for (_d, _r, fits, _v), g in zip(routes, got)]
    overflow = [(~fits).sum(dim=1) for _d, _r, fits, _v in routes]
    home = hi.device
    return _home(ans, home).reshape(-1), _home(overflow, home)


def _distributed_write(op: str, mesh: ShardMesh, axis: str,
                       state: ShardedFilterState, hi, lo, *, fops: FilterOps,
                       capacity_factor: float, donate: bool, valid=None,
                       route: str = "key"):
    n_shards = mesh.shape[axis]
    _on_mesh(mesh, state)
    per_shard = hi.shape[0] // n_shards
    cap = _capacity(per_shard, capacity_factor, n_shards)
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    routes, recvs = _routed_out(mesh, hi, lo, valid, per_shard, cap,
                                route=route, n_buckets=_route_nb(state),
                                fp_bits=fops.fp_bits)
    run = fops.insert_table if op == "insert" else fops.delete_table
    table_parts, stash_parts, answers = [], [], []
    for q, recv in enumerate(recvs):
        r_hi, r_lo, r_valid = _fields(recv)
        tables = state.table_parts[q]
        tables = tables if donate else tables.clone()
        stashes = (None if state.stash_parts is None
                   else state.stash_parts[q])
        if stashes is not None and not donate:
            stashes = stashes.clone()
        oks = []
        for i in range(tables.shape[0]):
            out = run(tables[i], r_hi[i], r_lo[i],
                      n_buckets=state.n_buckets, valid=r_valid[i],
                      stash=None if stashes is None else stashes[i])
            tables[i].copy_(out[0])
            if stashes is not None:
                stashes[i].copy_(out[1])
            oks.append(out[-1] & r_valid[i])
        table_parts.append(tables)
        stash_parts.append(stashes)
        answers.append(torch.stack(oks).reshape(recv.shape[0], n_shards,
                                                cap))
    ok = _answers_back(mesh, answers, routes)
    deferred = [~fits & v for _d, _r, fits, v in routes]   # resubmit these
    overflow = [x.sum(dim=1) for x in deferred]
    new_state = ShardedFilterState(
        tuple(table_parts),
        None if state.stash_parts is None else tuple(stash_parts),
        state.n_buckets)
    home = hi.device
    return (new_state, _home(ok, home).reshape(-1),
            _home(deferred, home).reshape(-1), _home(overflow, home))


def distributed_insert(mesh: ShardMesh, axis: str, state: ShardedFilterState,
                       hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                       capacity_factor: float = 2.0, backend: str = "auto",
                       evict_rounds: Optional[int] = None,
                       max_disp: int = 500, schedule: bool = True,
                       donate: bool = False, valid=None, route: str = "key"):
    """Routed bulk insert across filter shards
    -> (new_state, ok bool[N], deferred bool[N], overflow int64[S]), the
    masks and counts on ``hi``'s device.

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
    """Swap one shard's table, on its device (control plane: after a
    per-shard rebuild).  The other shards' tables are copied too, so the
    input state stays as it was."""
    parts = tuple(t.clone() for t in state.table_parts)
    p, i = state._locate(shard)
    parts[p][i] = table.to(parts[p].device)
    return state._replace(table_parts=parts)


def local_shard_delete_host(state: ShardedFilterState, shard: int,
                            hi: torch.Tensor, lo: torch.Tensor, *,
                            fp_bits: int, backend: str = "auto",
                            n_buckets=None
                            ) -> tuple[ShardedFilterState, torch.Tensor]:
    """Verified delete on one shard, on its device (control plane)
    -> (state, deleted).

    ``n_buckets`` defaults to the state's ACTIVE count, else the buffer's
    rows."""
    table = state.table(shard)
    if n_buckets is None:
        n_buckets = _route_nb(state)
    st = FilterState(table, torch.zeros((), dtype=torch.int64,
                                        device=table.device), int(n_buckets))
    st, ok = FilterOps(fp_bits=fp_bits, backend=backend).delete(
        st, hi.to(table.device), lo.to(table.device))
    return local_shard_insert_host(state, shard, st.table), ok


def replicated_lookup(tables, hi: torch.Tensor, lo: torch.Tensor, *,
                      fp_bits: int, backend: str = "auto") -> torch.Tensor:
    """Probe every shard (broadcast query: "is this key anywhere?") ->
    bool[N] on ``hi``'s device.  ``tables`` is a stacked [S, buffer, b]
    tensor or a state's ``table_parts``: each shard probes on its
    device."""
    fops = FilterOps(fp_bits=fp_bits, backend=backend)
    parts = (tables,) if isinstance(tables, torch.Tensor) else tuple(tables)
    hits = []
    for part in parts:
        h, l = hi.to(part.device), lo.to(part.device)
        hit = torch.zeros(hi.shape, dtype=torch.bool, device=part.device)
        for t in part:
            hit |= fops.probe_table(t, h, l)
        hits.append(hit)
    out = hits[0].to(hi.device)
    for hit in hits[1:]:
        out = out | hit.to(hi.device)
    return out
