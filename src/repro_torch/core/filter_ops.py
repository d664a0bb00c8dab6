"""`FilterOps` — the filter data plane every consumer goes through.

Counterpart of ``repro.core.filter_ops.FilterOps``.  All ops speak (hi, lo)
int32 key halves and the dynamic-capacity ``FilterState`` (active
``n_buckets`` inside a pow2 buffer).  ``backend``:

  * ``"cuda"``  — the hand-written kernels (``kernels/``), counterpart of
                  the reference's ``"pallas"``.  On CUDA tensors they
                  launch the kernels; on CPU tensors (``device="cpu"``) the
                  kernel modules run their plain PyTorch versions.
  * ``"auto"``  — resolves to ``"cuda"``.
  * ``"torch"`` — reserved for the counterpart of the reference's
                  ``"jnp"`` scan backend (``core/filter.py::bulk_*``); it
                  raises ``NotImplementedError`` until that is ported.

``donate=True`` means the mutating ops update the caller's table and stash
tensors IN PLACE (the reference donated the buffers to XLA); with
``donate=False`` they work on copies and leave the inputs untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from repro_torch.core.filter import FilterState, make_state
from repro_torch.kernels import ops as kops
from repro_torch.kernels.stash import stash_occupancy

Backend = Literal["cuda", "auto", "torch"]


def evict_rounds_for_load(load: float) -> int:
    """Eviction-round budget for a target operating load, pow2-rounded.

    ``4 / (1 - load)`` rounds rounded up to a power of two and clamped to
    [8, 256]: 32 at the OCF's default ``o_max = 0.85``, 64 at 0.9.
    """
    load = min(max(load, 0.0), 0.97)
    need = 4.0 / (1.0 - load)
    r = 8
    while r < need and r < 256:
        r <<= 1
    return r


@dataclasses.dataclass(frozen=True)
class FilterOps:
    """Lookup / insert / delete / rebuild entry points over the kernels.

    ``evict_rounds`` bounds the insert kernel's eviction rounds (default:
    the budget for the 0.85 operating load).  A key that exhausts it (and
    finds no stash slot) reports False with the table rolled back; the OCF
    answers with grow + rebuild.  ``schedule`` turns on the conflict-wave
    pre-pass of inserts (``core/scheduling.py``).
    """

    fp_bits: int = 16
    backend: Backend = "auto"
    evict_rounds: Optional[int] = None
    schedule: bool = False
    donate: bool = False

    def __post_init__(self):
        if self.backend not in ("cuda", "auto", "torch"):
            raise ValueError(f"unknown filter backend {self.backend!r} "
                             "(expected 'cuda' | 'auto' | 'torch')")
        if self.backend == "torch":
            raise NotImplementedError(
                "backend='torch' (the scan backend, counterpart of the "
                "reference's 'jnp') is not ported yet; use 'cuda'")
        if self.evict_rounds is None:
            object.__setattr__(self, "evict_rounds",
                               evict_rounds_for_load(0.85))

    # ------------------------------------------------------------- ops --

    def lookup(self, state: FilterState, hi: torch.Tensor,
               lo: torch.Tensor) -> torch.Tensor:
        """Membership for a batch -> bool[N]."""
        return kops.probe_dispatch(state.table, hi, lo, fp_bits=self.fp_bits,
                                   n_buckets=state.n_buckets)

    def insert(self, state: FilterState, hi: torch.Tensor, lo: torch.Tensor,
               valid: Optional[torch.Tensor] = None
               ) -> tuple[FilterState, torch.Tensor]:
        """Bulk insert -> (state, ok[N]): optimistic rounds plus bounded
        eviction rounds in one kernel launch."""
        table, ok = kops.filter_insert(
            state.table, hi, lo, fp_bits=self.fp_bits,
            n_buckets=state.n_buckets, valid=valid,
            evict_rounds=self.evict_rounds, schedule=self.schedule,
            donate=self.donate)
        return FilterState(table, state.count + ok.sum(),
                           state.n_buckets), ok

    def lookup_with_stash(self, state: FilterState, stash: torch.Tensor,
                          hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """Membership against table AND overflow stash -> bool[N]."""
        return kops.probe_dispatch(state.table, hi, lo, fp_bits=self.fp_bits,
                                   n_buckets=state.n_buckets, stash=stash)

    def insert_spill(self, state: FilterState, stash: torch.Tensor,
                     hi: torch.Tensor, lo: torch.Tensor,
                     valid: Optional[torch.Tensor] = None
                     ) -> tuple[FilterState, torch.Tensor, torch.Tensor]:
        """Bulk insert that spills overflow to the stash
        -> (state, stash, ok[N]).

        ``state.count`` tracks table-resident fingerprints only; stashed
        entries are counted by ``stash_occupancy``.
        """
        spilled_before = stash_occupancy(stash)
        table, new_stash, ok = kops.filter_insert(
            state.table, hi, lo, fp_bits=self.fp_bits,
            n_buckets=state.n_buckets, valid=valid,
            evict_rounds=self.evict_rounds, stash=stash,
            schedule=self.schedule, donate=self.donate)
        newly_stashed = stash_occupancy(new_stash) - spilled_before
        count = state.count + ok.sum() - newly_stashed
        return FilterState(table, count, state.n_buckets), new_stash, ok

    def delete(self, state: FilterState, hi: torch.Tensor, lo: torch.Tensor,
               valid: Optional[torch.Tensor] = None
               ) -> tuple[FilterState, torch.Tensor]:
        """Verified bulk delete -> (state, ok[N]).  The k-th duplicate key
        clears the k-th resident copy; callers verify membership first."""
        table, ok = kops.filter_delete(
            state.table, hi, lo, fp_bits=self.fp_bits,
            n_buckets=state.n_buckets, valid=valid, donate=self.donate)
        return FilterState(table, state.count - ok.sum(),
                           state.n_buckets), ok

    def rebuild(self, hi: torch.Tensor, lo: torch.Tensor, n_buckets: int,
                bucket_size: int, *, buffer_buckets: Optional[int] = None,
                valid: Optional[torch.Tensor] = None
                ) -> tuple[FilterState, torch.Tensor]:
        """Re-insert a keystore batch into a fresh table (resize path)."""
        state = make_state(n_buckets, bucket_size,
                           buffer_buckets=buffer_buckets, device=hi.device)
        return self.insert(state, hi, lo, valid=valid)

    # --------------------------------------------------- raw-table ops --

    def probe_table(self, table: torch.Tensor, hi: torch.Tensor,
                    lo: torch.Tensor, *, n_buckets: Optional[int] = None,
                    stash: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Membership probe on a bare table (plus optional stash)."""
        return kops.probe_dispatch(table, hi, lo, fp_bits=self.fp_bits,
                                   n_buckets=n_buckets, stash=stash)

    def insert_table(self, table: torch.Tensor, hi: torch.Tensor,
                     lo: torch.Tensor, *, n_buckets: Optional[int] = None,
                     valid: Optional[torch.Tensor] = None,
                     stash: Optional[torch.Tensor] = None):
        """Bare-table bulk insert on copies -> (table, ok[N]) or
        (table, stash, ok[N])."""
        return kops.filter_insert(table, hi, lo, fp_bits=self.fp_bits,
                                  n_buckets=n_buckets, valid=valid,
                                  evict_rounds=self.evict_rounds,
                                  stash=stash, schedule=self.schedule)

    def delete_table(self, table: torch.Tensor, hi: torch.Tensor,
                     lo: torch.Tensor, *, n_buckets: Optional[int] = None,
                     valid: Optional[torch.Tensor] = None):
        """Bare-table verified delete on a copy -> (table, ok[N])."""
        return kops.filter_delete(table, hi, lo, fp_bits=self.fp_bits,
                                  n_buckets=n_buckets, valid=valid)
