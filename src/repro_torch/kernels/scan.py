"""Sequential insert and delete walks: the scan backend's two kernels.

Counterpart of the reference's ``lax.scan`` cores, not of a
``pallas_call``: ``repro.core.filter._insert_one`` (walked lane by lane by
``bulk_insert`` and by ``repro.distributed.elastic.insert_pairs``) and the
per-key body of ``repro.core.filter.bulk_delete``.  Both are sequential by
definition: each lane sees the table the previous lane left.

``scan_insert``, per valid lane in order:

  1. place the fingerprint in the first empty slot of ``i1``, else of ``i2``;
  2. else evict from ``i2``: step k swaps the carried fingerprint into slot
     ``k % bucket_size`` of the current bucket, moves to the victim's
     alternate bucket and stops once that bucket has an empty slot, for at
     most ``max_disp`` steps, recording each visited bucket;
  3. an exhausted chain is rolled back through that history (the table is
     left exactly as before the lane) and, with a stash, the lane's
     ``(fp, i2)`` takes the stash's first empty slot
     (``kernels/stash.py::stash_spill`` for one lane); else it fails.

Lanes come in two modes: ``"key"`` — ``(hi, lo)`` key halves, hashed to
``fp, i1, i2`` by the filter's hash family; ``"pair"`` — migrated
``(bucket, fp)`` slots, with ``i1 = bucket mod n`` and ``i2 = alt(i1,
fp)``.

``scan_delete``, per valid lane in order: clear the first slot of ``i1``
holding the fingerprint, else of ``i2``.  This interleaves home and
alternate per key, unlike ``delete_bulk``'s all-home-then-all-alternate
rounds.

Both take a stack of shards, ``tables`` int32[S, buffer, bucket_size]
(a single [buffer, bucket_size] table is one shard), with lanes [S, L]
and update the tables (and stashes) IN PLACE.  Shards are independent.
The wrappers compact the valid lanes first (order kept), so mostly-empty
receive buffers cost nothing.  The CUDA kernels (``csrc/scan.cu``, whose
header argues why each result is the sequential walk's): ``scan_insert``
takes each shard's lanes in windows of ``window`` lanes, one CTA a shard,
every shard in one launch; the CTA's threads read every lane's two rows
(and walk short eviction chains) at once against the table the earlier
windows left, then one warp commits the lanes in order, taking a lane's
speculation where no row it read was written since and walking it from the
live table otherwise.  ``scan_delete`` groups the lanes by their conflict
key (shard, fingerprint, lower bucket of the pair; ``delete_groups``: a
stable sort on the card) and walks the groups in parallel, each group's
lanes in order.  The plain versions walk the same lanes on the host, one
after another: they are the semantics.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.kernels import cuda

# The reference's default chain budgets: ``bulk_insert`` and ``FilterOps``
# (500) and the elastic migration's ``insert_pairs`` (64).
DEFAULT_MAX_DISP = 500
MODES = ("key", "pair")
# Lanes a window of the ``scan_insert`` kernel: the callers' default, and
# the largest the kernel takes beside a 2^20-bucket dirty set in the
# H100's 227 KB of shared memory.
DEFAULT_WINDOW = 2048
MAX_WINDOW = 4096
# The insert kernel's schedule counts (``stats=``): lanes taken from their
# direct speculation, taken as a speculated chain, walked because a row they
# read was written earlier in the window, walked as chains.
SCHEDULE_FIELDS = ("direct", "chain", "dirty", "walked")
_M = hashing.MASK32
# Mixes the shard into a delete's conflict key (odd, below 2^63).
_SHARD_MIX = 0x2545F4914F6CDD1D


# ------------------------------------------------------------ host walk ---


def _splitmix32(x: int) -> int:
    x = (x + 0x9E3779B9) & _M
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M
    return x ^ (x >> 16)


def _alt(i: int, fp: int, n: int) -> int:
    return (_splitmix32(fp) % n + n - i % n) % n


def _lanes(mode: str, a, b, n_buckets: int, fp_bits):
    """(fp, i1, i2) uint32 numpy arrays of a lane batch."""
    if mode == "key":
        fp = hashing.fingerprint(a, b, fp_bits)
        i1 = hashing.index_hash(a, b, n_buckets)
    else:
        fp = hashing.to_u32(b)
        i1 = hashing.to_u32(a) % int(n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    return [x.cpu().numpy().astype(np.int64) for x in (fp, i1, i2)]


def _place(row: np.ndarray, f: int) -> bool:
    empty = np.flatnonzero(row == 0)
    if empty.size == 0:
        return False
    row[empty[0]] = f
    return True


def _insert_one(t: np.ndarray, f: int, i1: int, i2: int, n: int,
                max_disp: int) -> bool:
    """``repro.core.filter._insert_one`` on a uint32 [buffer, b] array."""
    if _place(t[i1], f) or _place(t[i2], f):
        return True
    bs = t.shape[1]
    hist = []
    i, cur = i2, f
    while len(hist) < max_disp:
        j = len(hist) % bs
        old = int(t[i, j])
        t[i, j] = cur
        hist.append(i)
        cur = old
        i = _alt(i, cur, n)
        if _place(t[i], cur):
            return True
    for idx in range(len(hist) - 1, -1, -1):
        bi, bj = hist[idx], idx % bs
        old = int(t[bi, bj])
        t[bi, bj] = cur
        cur = old
    return False


def _spill(stash: np.ndarray, f: int, bucket: int) -> bool:
    empty = np.flatnonzero(stash[0] == 0)
    if empty.size == 0:
        return False
    stash[0, empty[0]] = f
    stash[1, empty[0]] = bucket
    return True


def _as_host(x: torch.Tensor) -> np.ndarray:
    """uint32 numpy view of a CPU int32 tensor (writes go through)."""
    return x.numpy().view(np.uint32)


def _shards(tables, *lanes):
    """A [buffer, b] table and [L] lanes as one shard of a stack."""
    if tables.dim() == 2:
        return (tables[None],) + tuple(
            None if x is None else x[None] for x in lanes)
    return (tables,) + lanes


def scan_insert_plain(tables, a, b, valid, *, n_buckets: int, mode: str,
                      fp_bits, max_disp: int, stashes=None) -> torch.Tensor:
    """Plain version: each shard's valid lanes in order, IN PLACE -> ok."""
    cuda.PLAIN_CALLS["scan_insert"] += 1
    host = tables if tables.device.type == "cpu" else tables.cpu()
    s_host = None
    if stashes is not None:
        s_host = stashes if stashes.device.type == "cpu" else stashes.cpu()
    ok = torch.zeros(valid.shape, dtype=torch.bool)
    n = int(n_buckets)
    for s in range(host.shape[0]):
        lanes = torch.nonzero(valid[s].cpu()).flatten()
        if lanes.numel() == 0:
            continue
        fp, i1, i2 = _lanes(mode, a[s][lanes.to(a.device)],
                            b[s][lanes.to(b.device)], n, fp_bits)
        t = _as_host(host[s])
        st = None if s_host is None else _as_host(s_host[s])
        for k, lane in enumerate(lanes.tolist()):
            f, h1, h2 = int(fp[k]), int(i1[k]), int(i2[k])
            done = _insert_one(t, f, h1, h2, n, max_disp)
            if not done and st is not None:
                done = _spill(st, f, h2)
            ok[s, lane] = done
    if host is not tables:
        tables.copy_(host)
    if s_host is not None and s_host is not stashes:
        stashes.copy_(s_host)
    return ok.to(valid.device)


def scan_delete_plain(tables, hi, lo, valid, *, n_buckets: int,
                      fp_bits: int) -> torch.Tensor:
    """Plain version: each shard's valid lanes in order, IN PLACE -> ok."""
    cuda.PLAIN_CALLS["scan_delete"] += 1
    host = tables if tables.device.type == "cpu" else tables.cpu()
    ok = torch.zeros(valid.shape, dtype=torch.bool)
    n = int(n_buckets)
    for s in range(host.shape[0]):
        lanes = torch.nonzero(valid[s].cpu()).flatten()
        if lanes.numel() == 0:
            continue
        fp, i1, i2 = _lanes("key", hi[s][lanes.to(hi.device)],
                            lo[s][lanes.to(lo.device)], n, fp_bits)
        t = _as_host(host[s])
        for k, lane in enumerate(lanes.tolist()):
            f = int(fp[k])
            for i in (int(i1[k]), int(i2[k])):
                hit = np.flatnonzero(t[i] == f)
                if hit.size:
                    t[i, hit[0]] = 0
                    ok[s, lane] = True
                    break
    if host is not tables:
        tables.copy_(host)
    return ok.to(valid.device)


# ---------------------------------------------------------------- kernels --


def _compact(valid: torch.Tensor, *lanes):
    """Valid lanes of every shard, in order -> (index [M, 2], offsets
    int64[S + 1], compacted lanes [M] each)."""
    idx = torch.nonzero(valid)
    offsets = torch.zeros(valid.shape[0] + 1, dtype=torch.int64,
                          device=valid.device)
    offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)
    return idx, offsets, [x[idx[:, 0], idx[:, 1]].contiguous()
                          for x in lanes]


def _check(name, tables, a, b, valid, n_buckets, stashes=None):
    cuda.check_cuda(name, tables=tables, a=a, b=b, valid=valid,
                    stashes=stashes)
    cuda.check_dtype(name, torch.int32, tables=tables, a=a, b=b,
                     stashes=stashes)
    cuda.check_dtype(name, torch.bool, valid=valid)
    cuda.check_table(name, tables[0], n_buckets,
                     None if stashes is None else stashes[0])


def _uncompact(valid, idx, ok_c):
    """The compacted lanes' ok back in place -> ok bool[S, L]."""
    ok = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    ok[idx[:, 0], idx[:, 1]] = ok_c
    return ok


def _scan_insert_cuda(tables, a, b, valid, *, n_buckets, mode, fp_bits,
                      max_disp, stashes, window=DEFAULT_WINDOW, stats=None):
    _check("scan_insert", tables, a, b, valid, n_buckets, stashes)
    if stats is not None:
        cuda.check_cuda("scan_insert", tables=tables, stats=stats)
        cuda.check_dtype("scan_insert", torch.int64, stats=stats)
    idx, offsets, (a_c, b_c) = _compact(valid, a, b)
    ok_c = torch.zeros((idx.shape[0],), dtype=torch.bool,
                       device=tables.device)
    if idx.shape[0]:
        cuda.launch("scan_insert", tables.device, tables.data_ptr(),
                    tables.shape[1], tables.shape[2], int(n_buckets),
                    cuda.ptr(stashes), 0 if stashes is None else stashes.shape[2],
                    a_c.data_ptr(), b_c.data_ptr(), offsets.data_ptr(),
                    ok_c.data_ptr(), tables.shape[0], MODES.index(mode),
                    int(fp_bits or 0), int(max_disp), int(window),
                    cuda.ptr(stats))
    return _uncompact(valid, idx, ok_c)


def delete_groups(hi, lo, valid, *, n_buckets: int, fp_bits: int):
    """The grouping of a ``scan_delete`` launch, on the lanes' device:
    compact the valid lanes of [S, L] ``hi``, ``lo`` (order kept), key each
    by its conflict key (shard, fingerprint, lower bucket of its pair; two
    lanes with different keys touch different slots) and sort the keys
    stably -> (index [M, 2], offsets int64[S + 1], hi [M], lo [M], sorted
    keys int64[M], perm int64[M]: the compacted lane at each sorted
    position).  Lanes of one key are adjacent and in lane order."""
    idx, offsets, (hi_c, lo_c) = _compact(valid, hi, lo)
    fp = hashing.fingerprint(hi_c, lo_c, fp_bits)
    i1 = hashing.index_hash(hi_c, lo_c, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    key = (fp << 31) | torch.minimum(i1, i2)
    key ^= idx[:, 0] * _SHARD_MIX
    keys, perm = torch.sort(key, stable=True)
    return idx, offsets, hi_c, lo_c, keys, perm


def _scan_delete_cuda(tables, hi, lo, valid, *, n_buckets, fp_bits):
    _check("scan_delete", tables, hi, lo, valid, n_buckets)
    idx, offsets, hi_c, lo_c, keys, perm = delete_groups(
        hi, lo, valid, n_buckets=n_buckets, fp_bits=fp_bits)
    ok_c = torch.zeros((idx.shape[0],), dtype=torch.bool,
                       device=tables.device)
    if idx.shape[0]:
        cuda.launch("scan_delete", tables.device, tables.data_ptr(),
                    tables.shape[1], tables.shape[2], int(n_buckets),
                    hi_c.data_ptr(), lo_c.data_ptr(), offsets.data_ptr(), tables.shape[0],
                    keys.data_ptr(), perm.data_ptr(), idx.shape[0],
                    ok_c.data_ptr(), int(fp_bits))
    return _uncompact(valid, idx, ok_c)


def scan_insert(tables: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                n_buckets: int | None = None, mode: str = "key",
                fp_bits: int | None = None,
                max_disp: int = DEFAULT_MAX_DISP,
                valid: torch.Tensor | None = None,
                stashes: torch.Tensor | None = None,
                window: int = DEFAULT_WINDOW,
                stats: torch.Tensor | None = None) -> torch.Tensor:
    """Sequential insert walk over each shard's lanes, IN PLACE -> ok.

    ``tables``: int32[S, buffer, bucket_size] (or one [buffer,
    bucket_size] table); ``a``, ``b``: int32 [S, L] (or [L]) lanes, the key
    halves ``(hi, lo)`` in ``mode="key"`` (needs ``fp_bits``) or the
    migrated ``(bucket, fp)`` in ``mode="pair"``; ``valid``: bool, the
    lanes to walk; ``stashes``: optional int32[S, 2, slots] (or [2,
    slots]) that exhausted chains spill to.  ``window``: the kernel's lanes
    a window, 1 to ``MAX_WINDOW`` (the result does not depend on it);
    ``stats``: an optional int64[4] CUDA tensor the kernel adds its lanes'
    schedule to (``SCHEDULE_FIELDS``; the plain version has no schedule and
    leaves it alone).  CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"scan_insert: window {window} is not in "
                         f"[1, {MAX_WINDOW}]")
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r} (expected {MODES})")
    if mode == "key" and fp_bits is None:
        raise ValueError("scan_insert: mode='key' needs fp_bits")
    if valid is None:
        valid = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    tables3, a, b, valid, stashes = _shards(tables, a, b, valid, stashes)
    n_buckets = tables3.shape[1] if n_buckets is None else n_buckets
    args = dict(n_buckets=n_buckets, mode=mode, fp_bits=fp_bits,
                max_disp=max_disp, stashes=stashes)
    if tables3.device.type == "cpu":
        ok = scan_insert_plain(tables3, a, b, valid, **args)
    else:
        ok = _scan_insert_cuda(tables3, a, b, valid, window=window,
                               stats=stats, **args)
    return ok[0] if tables.dim() == 2 else ok


def scan_delete(tables: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Sequential delete walk over each shard's keys, IN PLACE -> ok.

    Shapes as ``scan_insert``'s key mode.  Callers verify membership first:
    clearing a fingerprint that was never inserted corrupts another key's
    slot.  CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    tables3, hi, lo, valid = _shards(tables, hi, lo, valid)
    n_buckets = tables3.shape[1] if n_buckets is None else n_buckets
    run = (scan_delete_plain if tables3.device.type == "cpu"
           else _scan_delete_cuda)
    ok = run(tables3, hi, lo, valid, n_buckets=n_buckets, fp_bits=fp_bits)
    return ok[0] if tables.dim() == 2 else ok
