"""Elastic resharding of the sharded filter: live split and merge.

Counterpart of the filter part of ``repro.distributed.elastic``
(``filter_mesh``, ``insert_pairs``, the migration round, ``MigrationReport``,
``migrate_state``, ``split_state``, ``merge_state``, ``ElasticController``)
and of its mesh elasticity for the LM stack (``largest_mesh``,
``reshard_state``) on ``torch.distributed`` ``DeviceMesh``es.

A resident slot stores (bucket, fingerprint), and ``min(bucket, alt(bucket,
fp))`` plus the fingerprint identifies the key's bucket pair from either
end, so the pair owner (``hashing.owner_shard_pair``) is re-derivable from
the table alone.  The pair hash does not depend on the shard count, so
owners nest across pow2 counts (``owner(2n) mod n == owner(n)``): a 2x
split moves a subset of shard s's entries to s + n, a merge folds s + n
back onto s.  States that reshard are written with ``route="pair"``.

A migration round, for every shard at once: enumerate its lanes (table
slots with their row, stash entries with their stored bucket), compute the
pair owner under the target count, rank the foreign lanes per destination
(``conflict_waves``), clear at the source only the lanes that fit this
round's ``cap``, exchange ``(fp, bucket)`` buffers, and pair-insert what
each shard received with ``scan_insert`` (mode ``"pair"``, one launch a
part of the mesh over its stacked shards, exhausted chains spilled to the
shard's stash).  Each part does its share on its own device; the exchange
copies between parts (``core.distributed._exchange``).  Rounds repeat
until no shard holds a foreign lane.

Meshes come from ``filter_mesh``: one part a shard on the given
``devices`` (the reference's layout), or one part on ``device``.  A split
keeps shards 0..n-1 where they were and seeds n..2n-1 on the new mesh's
devices; a merge drains onto the old mesh and drops its top half's
shards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core import hashing
from repro_torch.core.distributed import (ShardMesh, ShardedFilterState,
                                          _exchange, _fields, _on_mesh,
                                          _pack_routed, lay_out,
                                          place_shards, shard_layout)
from repro_torch.core.scheduling import conflict_waves
from repro_torch.kernels.scan import scan_insert

# The reference's chain budget for migrated lanes.
MIGRATION_MAX_DISP = 64


def filter_mesh(n_shards: int, axis_name: str = "data",
                devices=None, *, device="cuda") -> ShardMesh:
    """1-D filter mesh of ``n_shards`` shards.

    With ``devices``, shard s lies on ``devices[s]``, one part a shard, over
    the first ``n_shards`` of them (fewer raise); a device may repeat.
    Without, every shard lies on ``device`` in one part.  A card that is
    not there raises; nothing falls back to another device.  The elastic
    controller builds the pre- and post-cutover meshes with this, so a
    2->4 split and its 4->2 inverse agree on device order."""
    return ShardMesh(int(n_shards), axis_name,
                     shard_layout(int(n_shards), device=device,
                                  devices=devices))


def largest_mesh(ranks=None, *, model_parallel: int,
                 axis_names=("data", "model")):
    """Largest (data, model) ``DeviceMesh`` on the surviving ``ranks``
    (default: every rank of the process group).  Keeps TP fixed (the
    weights must still fit) and gives every remaining multiple of
    ``model_parallel`` ranks to data parallelism.  A CPU mesh, as
    ``launch.mesh``'s."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    data = n // model_parallel
    if data < 1:
        raise RuntimeError(
            f"{n} ranks cannot host model_parallel={model_parallel}")
    use = torch.tensor(ranks[:data * model_parallel]).reshape(
        data, model_parallel)
    return DeviceMesh("cpu", use, mesh_dim_names=tuple(axis_names))


def reshard_state(state: dict, specs: dict, new_mesh, parallel) -> dict:
    """Re-derive each tensor's layout from its logical spec on
    ``new_mesh`` and move it there: ``{name: tensor or DTensor}`` ->
    ``{name: DTensor}`` (a DTensor on the old mesh is gathered whole
    first; a ``meta`` tensor moves nothing)."""
    from repro_torch.distributed.sharding import (distribute, is_dtensor,
                                                  spec_to_pspec)
    out = {}
    for name, t in state.items():
        pspec = spec_to_pspec(tuple(specs[name]), tuple(t.shape), new_mesh,
                              parallel)
        if is_dtensor(t):
            t = (torch.empty(t.shape, dtype=t.dtype, device="meta")
                 if t.is_meta else t.full_tensor())
        out[name] = distribute(t, new_mesh, pspec)
    return out


def insert_pairs(table, stash, bucket, fp, valid, *, n_buckets,
                 max_disp: int = MIGRATION_MAX_DISP):
    """Insert migrated (bucket, fingerprint) pairs into one shard's slice
    -> (table, stash, ok bool[N]), on copies.

    ``i1 = bucket mod n_buckets``, ``i2 = alt(i1, fp)``, then the
    sequential insert (place, alternate, bounded eviction with rollback),
    spilling an exhausted chain's ``(fp, i2)`` to the stash.  Invalid lanes
    touch neither structure.
    """
    table, stash = table.clone(), stash.clone()
    ok = scan_insert(table, bucket, fp, n_buckets=n_buckets, mode="pair",
                     max_disp=max_disp, valid=valid, stashes=stash)
    return table, stash, ok


def _migrate_round(mesh: ShardMesh, table_parts, stash_parts, *,
                   target_shards: int, cap: int, n_buckets: int,
                   max_disp: int) -> list:
    """One migration round over every shard, IN PLACE on each part's
    tables and stashes -> per part, int64[3]: (moved, remaining, failed)
    summed over its shards, on its device.

    ``remaining`` counts foreign lanes still resident (the stop condition);
    ``failed`` counts received lanes that neither placed nor spilled.
    """
    n_mesh = mesh.n_shards
    sends, counts = [], []
    for (dev, a, _b), tables, stashes in zip(mesh.spans(), table_parts,
                                             stash_parts):
        n_p, buf, bs = tables.shape
        lane_fp = torch.cat([tables.reshape(n_p, -1), stashes[:, 0, :]], 1)
        rows = torch.arange(buf, dtype=torch.int32, device=dev)
        lane_bkt = torch.cat([rows.repeat_interleave(bs).expand(n_p, -1),
                              stashes[:, 1, :]], 1)
        me = torch.arange(n_p, device=dev)[:, None]
        owner = hashing.owner_shard_pair(lane_bkt, lane_fp, n_buckets,
                                         target_shards)
        foreign = (lane_fp != 0) & (owner != me + a)
        rank = conflict_waves((me * n_mesh + owner).reshape(-1),
                              foreign.reshape(-1)).reshape(owner.shape)
        fits = (rank < cap) & foreign
        dst = torch.where(fits, owner, n_mesh)
        # Clear shipped lanes at the source before inserting received
        # ones, so a shard that both sends and receives reuses the freed
        # slots.
        sends.append(_pack_routed(dst, rank, fits, n_mesh, cap, lane_fp,
                                  lane_bkt))
        n_table = buf * bs
        tables.reshape(n_p, -1).masked_fill_(fits[:, :n_table], 0)
        stashes.masked_fill_(fits[:, None, n_table:], 0)
        counts.append([fits.sum(), (foreign & ~fits).sum()])
    for recv, tables, stashes, c in zip(_exchange(sends, mesh), table_parts,
                                        stash_parts, counts):
        r_fp, r_bkt, r_valid = _fields(recv)
        ok = scan_insert(tables, r_bkt, r_fp, n_buckets=n_buckets,
                         mode="pair", max_disp=max_disp, valid=r_valid,
                         stashes=stashes)
        c.append((r_valid & ~ok).sum())
    return [torch.stack(c) for c in counts]


@dataclasses.dataclass
class MigrationReport:
    """What one split/merge did — the recovery-metrics payload."""
    direction: str          # "split" | "merge"
    old_shards: int
    new_shards: int
    keys_moved: int         # fingerprints shipped shard-to-shard
    rounds: int             # exchange rounds until drained
    failed: int             # received lanes lost to full destinations
    seconds: float = 0.0    # migration wall time (filled by split/merge)


def migrate_state(mesh: ShardMesh, axis: str, state: ShardedFilterState, *,
                  target_shards: int, cap: Optional[int] = None,
                  max_disp: int = MIGRATION_MAX_DISP, max_rounds: int = 64):
    """Stream every mis-owned lane to its pair owner under ``target_shards``
    -> (new_state, moved, rounds, failed); the input state is left as it
    was.

    ``cap`` bounds fingerprints per (source, destination) pair per round
    (default: everything a shard holds, one round).  Requires stashes.
    """
    _require_stashes(state)
    if state.n_shards != mesh.shape[axis]:
        raise ValueError(f"{state.n_shards} shards on a mesh of "
                         f"{mesh.shape[axis]}")
    _on_mesh(mesh, state)
    _n, buf, bs = state.table_parts[0].shape
    n_buckets = state.n_buckets if state.n_buckets is not None else buf
    if cap is None:
        cap = n_buckets * bs + state.stash_parts[0].shape[2]
    tables = tuple(t.clone() for t in state.table_parts)
    stashes = tuple(s.clone() for s in state.stash_parts)
    moved_total = rounds = failed_total = 0
    while True:
        per_part = _migrate_round(
            mesh, tables, stashes, target_shards=target_shards, cap=cap,
            n_buckets=n_buckets, max_disp=max_disp)
        # one host read a part, after every part's round is issued
        moved, remaining, failed = (
            sum(c) for c in zip(*(x.tolist() for x in per_part)))
        rounds += 1
        moved_total += moved
        failed_total += failed
        if remaining == 0:
            break
        if rounds >= max_rounds:
            raise RuntimeError(
                f"migration did not drain in {max_rounds} rounds "
                f"({remaining} lanes still foreign)")
    new_state = state._replace(table_parts=tables, stash_parts=stashes)
    return new_state, moved_total, rounds, failed_total


def _require_stashes(state: ShardedFilterState) -> None:
    if state.stash_parts is None:
        raise ValueError("elastic migration requires per-shard stashes "
                         "(spill target)")


def _sync(devices) -> None:
    """Wait for every card among ``devices``."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def split_state(new_mesh: ShardMesh, axis: str, state: ShardedFilterState, *,
                cap: Optional[int] = None,
                max_disp: int = MIGRATION_MAX_DISP, max_rounds: int = 64
                ) -> tuple[ShardedFilterState, MigrationReport]:
    """Grow a pair-routed state 2x, live and rebuild-free: shard s < n keeps
    old shard s (on the new mesh's device for it: the same one where the
    meshes come from ``filter_mesh`` over one device list), shards
    n..2n-1 start empty on theirs, then the migration runs on the NEW
    mesh.  Every foreign lane of shard s goes to s + n, and a destination
    bucket receives at most one source bucket's slots, so a split cannot
    overfill."""
    _require_stashes(state)
    n_old = state.n_shards
    n_new = new_mesh.shape[axis]
    if n_new != 2 * n_old or n_new & (n_new - 1):
        raise ValueError(f"a split doubles a pow2 shard count: {n_old} -> "
                         f"{n_new}")
    t0 = time.perf_counter()
    devs = new_mesh.devices
    t0_shape, s0_shape = state.table(0).shape, state.stash(0).shape
    seeded = place_shards(
        new_mesh.parts,
        [state.table(s) if s < n_old else
         torch.zeros(t0_shape, dtype=torch.int32, device=devs[s])
         for s in range(n_new)],
        [state.stash(s) if s < n_old else
         torch.zeros(s0_shape, dtype=torch.int32, device=devs[s])
         for s in range(n_new)], state.n_buckets)
    new_state, moved, rounds, failed = migrate_state(
        new_mesh, axis, seeded, target_shards=n_new, cap=cap,
        max_disp=max_disp, max_rounds=max_rounds)
    _sync(devs)
    return new_state, MigrationReport(
        "split", n_old, n_new, moved, rounds, failed,
        time.perf_counter() - t0)


def merge_state(old_mesh: ShardMesh, axis: str, state: ShardedFilterState, *,
                cap: Optional[int] = None,
                max_disp: int = MIGRATION_MAX_DISP, max_rounds: int = 64
                ) -> tuple[ShardedFilterState, MigrationReport]:
    """Shrink a pair-routed state 2x, live and rebuild-free: the migration
    runs on the OLD mesh with the halved owner (shard s + n/2 folds onto s,
    through the full pair insert: receivers are contended), then the
    drained top half's shards are dropped: shards 0..n/2-1 stay where the
    old mesh has them."""
    n_old = state.n_shards
    if n_old != old_mesh.shape[axis] or n_old % 2:
        raise ValueError(f"a merge halves an even shard count on its mesh, "
                         f"got {n_old}")
    k = n_old // 2
    t0 = time.perf_counter()
    new_state, moved, rounds, failed = migrate_state(
        old_mesh, axis, state, target_shards=k, cap=cap, max_disp=max_disp,
        max_rounds=max_rounds)
    top = [torch.stack([(new_state.table(s) != 0).sum(),
                        (new_state.stash(s)[0] != 0).sum()]).tolist()
           for s in range(k, n_old)]
    top = tuple(sum(c) for c in zip(*top))
    if top != (0, 0):
        raise RuntimeError(f"merge left {top[0]}+{top[1]} lanes on drained "
                           "shards")
    kept_parts, n = [], 0
    for dev, c in old_mesh.parts:       # the old parts, cut at shard k
        if n < k:
            kept_parts.append((dev, min(c, k - n)))
        n += c
    merged = place_shards(tuple(kept_parts),
                          [new_state.table(s) for s in range(k)],
                          [new_state.stash(s) for s in range(k)],
                          new_state.n_buckets)
    _sync(old_mesh.devices)
    return merged, MigrationReport(
        "merge", n_old, k, moved, rounds, failed, time.perf_counter() - t0)


# --------------------------------------------------- serving control plane


@dataclasses.dataclass
class ElasticController:
    """Zero-downtime split/merge over a live ``DeferredWritePump``.

    The cutover: (1) hold the pump (fresh submits park) and freeze write
    admission; (2) run the migration (split on the new mesh / merge on the
    old); (3) retarget the pump at the new (mesh, state) and release; (4)
    drain the parked backlog.  Time to recover is hold -> backlog drained.
    ``recovery`` is an optional ``obs.recovery.RecoveryMetrics``.
    """

    pump: object                               # serving DeferredWritePump
    axis: str = "data"
    recovery: Optional[object] = None
    cap: Optional[int] = None
    max_disp: int = MIGRATION_MAX_DISP
    max_rounds: int = 64
    drain_ticks: int = 100
    clock: Callable[[], float] = time.perf_counter

    def split(self, new_mesh: ShardMesh) -> MigrationReport:
        return self._resize("split", new_mesh)

    def merge(self, new_mesh: ShardMesh) -> MigrationReport:
        return self._resize("merge", new_mesh)

    def _resize(self, direction: str, new_mesh: ShardMesh) -> MigrationReport:
        pump, rec = self.pump, self.recovery
        t0 = self.clock()
        pump.hold()
        admission = getattr(pump, "admission", None)
        if admission is not None and hasattr(admission, "freeze"):
            admission.freeze()
        try:
            with (rec.span(f"elastic_{direction}",
                           new_shards=new_mesh.shape[self.axis])
                  if rec else _NULL_CTX):
                if direction == "split":
                    new_state, report = split_state(
                        new_mesh, self.axis, pump.state, cap=self.cap,
                        max_disp=self.max_disp, max_rounds=self.max_rounds)
                else:
                    # merge migrates on the OLD mesh, then lands on the new.
                    new_state, report = merge_state(
                        pump.mesh, self.axis, pump.state, cap=self.cap,
                        max_disp=self.max_disp, max_rounds=self.max_rounds)
                    new_state = lay_out(new_mesh, new_state)
                pump.retarget(new_mesh, self.axis, new_state)
        finally:
            if admission is not None and hasattr(admission, "thaw"):
                admission.thaw()
            pump.release()
        backlog = pump.pending
        pump.run_until_drained(max_ticks=self.drain_ticks)
        seconds = self.clock() - t0
        if rec is not None:
            rec.migration(direction, keys=report.keys_moved,
                          rounds=report.rounds, failed=report.failed,
                          seconds=report.seconds)
            rec.backlog(pump.pending)
            rec.drained(backlog - pump.pending)
            rec.recovered(f"elastic_{direction}", seconds)
        return report


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _Null()
