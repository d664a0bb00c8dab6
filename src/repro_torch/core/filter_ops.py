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
from typing import Literal, Optional, Sequence

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

    def fanout_prober(self, tables: torch.Tensor,
                      stashes: Optional[torch.Tensor], *, n_buckets: int,
                      gens: Optional[Sequence[int]] = None):
        """Pinned fan-out closure -> callable (hi, lo) -> bool[N].

        Membership across K generations: ``tables`` is
        int32[K, buffer_buckets, bucket_size] (the generation ring's pool),
        ``stashes`` int32[K, 2, S], ``gens`` the live generations' indices
        into K (default all), ``n_buckets`` their shared active count.  One
        fused ``probe_multi`` launch per call (keys hashed once); the block
        is pinned once, so the ring can reuse the closure across a batch's
        chunks.
        """
        return kops.multi_prober(tables, fp_bits=self.fp_bits,
                                 n_buckets=n_buckets, stashes=stashes,
                                 gens=gens)

    # ---------------------------------------------------- adaptive ops --
    #
    # Selector-aware entry points over the four-plane adaptive state
    # (``adaptive.state.AdaptiveState``, duck-typed here: anything with
    # table/sels/khi/klo/count/n_buckets fields and NamedTuple
    # ``_replace``).

    def lookup_adaptive(self, state, hi: torch.Tensor, lo: torch.Tensor,
                        stash: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Selector-aware membership -> bool[N]: a slot answers under ITS
        selector; stash entries are selector-0."""
        return kops.adaptive_lookup(state.table, state.sels, hi, lo,
                                    fp_bits=self.fp_bits,
                                    n_buckets=state.n_buckets, stash=stash)

    def insert_adaptive(self, state, hi: torch.Tensor, lo: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        stash: Optional[torch.Tensor] = None):
        """Bulk insert over the adaptive planes -> (state, ok[N]) or
        (state, stash, ok[N]).

        New entries land as selector-0 slots with the key mirrored; kicks
        reset the victim's selector; rollback restores all four planes.
        ``count`` tracks table-resident fingerprints only.
        """
        if stash is not None:
            spilled_before = stash_occupancy(stash)
        out = kops.adaptive_insert(
            state.table, state.sels, state.khi, state.klo, hi, lo,
            fp_bits=self.fp_bits, n_buckets=state.n_buckets, valid=valid,
            evict_rounds=self.evict_rounds, stash=stash,
            schedule=self.schedule, donate=self.donate)
        ok = out[-1]
        count = state.count + ok.sum()
        table, sels, khi, klo = out[:4]
        if stash is None:
            return state._replace(table=table, sels=sels, khi=khi, klo=klo,
                                  count=count), ok
        new_stash = out[4]
        count = count - (stash_occupancy(new_stash) - spilled_before)
        return state._replace(table=table, sels=sels, khi=khi, klo=klo,
                              count=count), new_stash, ok

    def delete_adaptive(self, state, hi: torch.Tensor, lo: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        stash: Optional[torch.Tensor] = None):
        """Verified bulk delete -> (state, ok[N]) or (state, stash, ok[N]).

        Slots match under THEIR selector; clearing zeroes all four planes.
        With a stash, lanes that miss the table clear their selector-0
        stash entry.
        """
        if stash is not None:
            stash_before = stash_occupancy(stash)
        out = kops.adaptive_delete(
            state.table, state.sels, state.khi, state.klo, hi, lo,
            fp_bits=self.fp_bits, n_buckets=state.n_buckets, valid=valid,
            stash=stash, donate=self.donate)
        ok = out[-1]
        table, sels, khi, klo = out[:4]
        count = state.count - ok.sum()
        if stash is None:
            return state._replace(table=table, sels=sels, khi=khi, klo=klo,
                                  count=count), ok
        new_stash = out[4]
        count = count + (stash_before - stash_occupancy(new_stash))
        return state._replace(table=table, sels=sels, khi=khi, klo=klo,
                              count=count), new_stash, ok

    def report_false_positive(self, state, hi: torch.Tensor,
                              lo: torch.Tensor,
                              valid: Optional[torch.Tensor] = None):
        """Feed confirmed false positives back -> (state, adapted[N],
        resident[N]).

        Every slot of a reported key's candidate pair whose stored
        fingerprint collides under that slot's selector is bumped to its
        next family member and rewritten from the mirrored resident key;
        ``resident`` flags reports that were true positives (never
        repaired).  Stash-resident collisions cannot adapt.
        """
        table, sels, adapted, resident = kops.adaptive_report(
            state.table, state.sels, state.khi, state.klo, hi, lo,
            fp_bits=self.fp_bits, n_buckets=state.n_buckets, valid=valid,
            donate=self.donate)
        return state._replace(table=table, sels=sels), adapted, resident

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
