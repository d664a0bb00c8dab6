"""Dynamic-capacity filter state and the scan backend's bulk ops.

Counterpart of ``repro.core.filter``.  The table lives in a preallocated
pow2 buffer; the ACTIVE bucket count ``n_buckets`` is a host ``int``
handed to every kernel as a plain argument (the TPU kept it in a
``(1, 1)`` SMEM scalar), so a resize changes no tensor shape.  ``count``
stays a device scalar.

The bulk ops are ``FilterOps(backend="torch")``, the counterpart of the
reference's ``"jnp"`` arm, with the same semantics:

  * ``bulk_lookup``          — both candidate buckets, vectorised;
  * ``bulk_insert``          — the exact sequential insert (place, alternate,
                               bounded eviction chain, lossless rollback),
                               walked by the ``scan_insert`` kernel;
  * ``parallel_insert_once`` — one vectorised optimistic round (in-batch
                               ranks, no chains);
  * ``bulk_insert_hybrid``   — the round, then ``bulk_insert`` on its
                               residue;
  * ``bulk_delete``          — the sequential delete (home, else alternate,
                               per key), walked by the ``scan_delete``
                               kernel.

Every op takes an optional ``valid`` mask and returns new tensors; the
input state is left as it was.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import hashing
from repro_torch.core.scheduling import conflict_waves
from repro_torch.kernels.scan import DEFAULT_MAX_DISP, scan_delete, scan_insert


class FilterState(NamedTuple):
    table: torch.Tensor   # int32[buffer_buckets, bucket_size]; 0 == EMPTY
    count: torch.Tensor   # int64[] live table fingerprints (device scalar)
    n_buckets: int        # ACTIVE bucket count (<= buffer_buckets)


def make_state(n_buckets: int, bucket_size: int = 4,
               buffer_buckets: Optional[int] = None, *,
               device="cuda") -> FilterState:
    """Empty state on ``device`` (raises if ``"cuda"`` has no card)."""
    dev = hashing.resolve_device(device)
    buf = buffer_buckets or n_buckets
    if buf < n_buckets:
        raise ValueError(f"buffer_buckets={buf} < n_buckets={n_buckets}")
    return FilterState(
        table=torch.zeros((buf, bucket_size), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int64, device=dev),
        n_buckets=int(n_buckets))


def table_state(table: torch.Tensor, n_buckets: Optional[int] = None
                ) -> FilterState:
    """A bare table as a state for the bulk ops (count 0, which the
    raw-table ops that call this ignore; ``n_buckets`` default: every
    row)."""
    n = table.shape[0] if n_buckets is None else int(n_buckets)
    return FilterState(table, torch.zeros((), dtype=torch.int64,
                                          device=table.device), n)


def _fp_i1_i2(hi, lo, n_buckets: int, fp_bits: int):
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    return fp, i1, hashing.alt_index(i1, fp, n_buckets)


def _valid(hi, valid):
    if valid is None:
        return torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    return valid


def bulk_lookup(state: FilterState, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int) -> torch.Tensor:
    """Membership for a batch of keys -> bool[N]."""
    fp, i1, i2 = _fp_i1_i2(hi, lo, state.n_buckets, fp_bits)
    fp = hashing.to_i32(fp)[:, None]
    return ((state.table[i1] == fp).any(dim=1)
            | (state.table[i2] == fp).any(dim=1))


def bulk_insert(state: FilterState, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, max_disp: int = DEFAULT_MAX_DISP,
                valid: Optional[torch.Tensor] = None
                ) -> tuple[FilterState, torch.Tensor]:
    """Sequential-semantics bulk insert -> (state, ok[N])."""
    table = state.table.clone()
    ok = scan_insert(table, hi, lo, n_buckets=state.n_buckets, mode="key",
                     fp_bits=fp_bits, max_disp=max_disp,
                     valid=_valid(hi, valid))
    return FilterState(table, state.count + ok.sum(), state.n_buckets), ok


def _round(table, target, active, fp):
    """One optimistic placement of every active lane into ``target``:
    lane i takes the rank-th empty slot of its bucket, its rank among the
    earlier active lanes of that bucket -> placed bool[N]."""
    rank = conflict_waves(target, active)
    empty = table[target] == 0
    fits = active & (rank < empty.sum(dim=1))
    empty_pos = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    slot = (empty & (empty_pos == rank[:, None])).to(torch.int8).argmax(1)
    table[target[fits], slot[fits]] = fp[fits]
    return fits


def parallel_insert_once(state: FilterState, hi, lo, *, fp_bits: int,
                         valid: Optional[torch.Tensor] = None
                         ) -> tuple[FilterState, torch.Tensor]:
    """One optimistic vectorised insert round (no eviction chains)."""
    valid = _valid(hi, valid)
    table = state.table.clone()
    fp, i1, i2 = _fp_i1_i2(hi, lo, state.n_buckets, fp_bits)
    fp = hashing.to_i32(fp)
    ok1 = _round(table, i1, valid, fp)
    ok2 = _round(table, i2, valid & ~ok1, fp)
    placed = ok1 | ok2
    return FilterState(table, state.count + placed.sum(),
                       state.n_buckets), placed


def bulk_insert_hybrid(state: FilterState, hi, lo, *, fp_bits: int,
                       max_disp: int = DEFAULT_MAX_DISP, valid=None
                       ) -> tuple[FilterState, torch.Tensor]:
    """Parallel optimistic round, then the sequential insert on the lanes
    it left (membership is order-independent; the layout is this
    schedule's)."""
    valid = _valid(hi, valid)
    state, placed = parallel_insert_once(state, hi, lo, fp_bits=fp_bits,
                                         valid=valid)
    residue = valid & ~placed
    ok2 = scan_insert(state.table, hi, lo, n_buckets=state.n_buckets,
                      mode="key", fp_bits=fp_bits, max_disp=max_disp,
                      valid=residue)
    return FilterState(state.table, state.count + ok2.sum(),
                       state.n_buckets), placed | ok2


def bulk_delete(state: FilterState, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, valid: Optional[torch.Tensor] = None
                ) -> tuple[FilterState, torch.Tensor]:
    """Sequential-semantics bulk delete -> (state, ok[N])."""
    table = state.table.clone()
    ok = scan_delete(table, hi, lo, n_buckets=state.n_buckets,
                     fp_bits=fp_bits, valid=_valid(hi, valid))
    return FilterState(table, state.count - ok.sum(), state.n_buckets), ok


def rebuild(keys_hi, keys_lo, n_buckets: int, bucket_size: int, *,
            fp_bits: int, max_disp: int = DEFAULT_MAX_DISP,
            buffer_buckets: Optional[int] = None, valid=None
            ) -> tuple[FilterState, torch.Tensor]:
    """Re-insert a keystore into a fresh table of the new active capacity
    (on the keys' device)."""
    state = make_state(n_buckets, bucket_size, buffer_buckets,
                       device=keys_hi.device)
    return bulk_insert_hybrid(state, keys_hi, keys_lo, fp_bits=fp_bits,
                              max_disp=max_disp, valid=valid)
