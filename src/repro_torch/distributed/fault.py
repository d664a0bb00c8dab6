"""Fault tolerance: injection, degraded serving and recovery (host control
plane).

Counterpart of ``repro.distributed.fault``:

  * ``FaultInjector`` kills / corrupts / delays a filter shard;
  * ``degraded_lookup`` keeps answering while a shard is lost: a key owned
    by a lost shard answers "maybe present" (a conservative positive),
    never a false negative;
  * ``recover_shard`` re-populates a lost shard from the last
    ``checkpoint.ckpt.save_sharded`` snapshot;
  * ``retry_routed_write`` / ``run_with_restarts`` bound the retries;
  * ``StragglerWatchdog`` flags slow steps.

A state that comes out of a fault or a recovery is laid out as the state
that went in: each part is copied on its device and the shard's rows are
written on its own device, so the next routed op runs where the mesh is.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import hashing

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the trailing median step time.

    With a ``metrics`` registry, every observation updates the
    ``straggler_last_ratio`` / ``straggler_median_s`` gauges and each flag
    increments ``straggler_flagged``.
    """

    factor: float = 3.0
    history: int = 64
    _times: list = dataclasses.field(default_factory=list)
    flagged: int = 0
    metrics: Optional[object] = None    # repro_torch.obs.MetricsRegistry

    def observe(self, step_seconds: float) -> bool:
        times = sorted(self._times[-self.history:])
        median = times[len(times) // 2] if times else None
        self._times.append(step_seconds)
        if median is not None and self.metrics is not None:
            self.metrics.gauge("straggler_median_s").set(median)
            self.metrics.gauge("straggler_last_ratio").set(
                step_seconds / median if median > 0 else 0.0)
        if median is not None and step_seconds > self.factor * median:
            self.flagged += 1
            if self.metrics is not None:
                self.metrics.counter("straggler_flagged").inc()
            log.warning("straggler: step %.3fs vs median %.3fs",
                        step_seconds, median)
            return True
        return False


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 0.1


def run_with_restarts(make_state: Callable[[Optional[int]], tuple],
                      run_from: Callable, policy: RestartPolicy,
                      *, latest_step_fn: Callable[[], Optional[int]]):
    """Restart loop: ``make_state(step|None)`` builds or restores state,
    ``run_from(state)`` runs to completion or raises; a failure restarts
    from the latest durable checkpoint, at most ``max_restarts`` times."""
    restarts = 0
    while True:
        step = latest_step_fn()
        state = make_state(step)
        try:
            return run_from(state)
        except Exception as e:  # noqa: BLE001 — any node failure
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            log.warning("step failed (%s); restart %d/%d from ckpt %s",
                        e, restarts, policy.max_restarts, latest_step_fn())
            time.sleep(policy.backoff_s * restarts)


def retry_routed_write(attempt: Callable[[], object], policy: RestartPolicy,
                       *, sleep: Callable[[float], None] = time.sleep):
    """Bounded retry with backoff ``backoff_s * failures`` around one routed
    write; after ``max_restarts`` failures the last exception re-raises."""
    failures = 0
    while True:
        try:
            return attempt()
        except Exception:  # noqa: BLE001 — injected faults are plain raises
            failures += 1
            if failures > policy.max_restarts:
                raise
            sleep(policy.backoff_s * failures)


# ----------------------------------------------------- fault injection --


class InjectedFault(RuntimeError):
    """Raised by injector-wrapped callables to simulate a node failure."""


class FaultInjector:
    """Kill / corrupt / delay filter shards.

    Tracks which shards are *lost* (killed or corrupted and not yet
    healed); ``degraded_lookup`` answers their keys conservatively.
    ``corrupt`` draws its words from ``np.random.default_rng(seed)``, as
    the reference does, so both packages scramble the same bits.
    """

    def __init__(self, recovery=None):
        self.lost: set[int] = set()
        self.recovery = recovery    # optional obs.recovery.RecoveryMetrics

    def _mark(self, kind: str, shard: int):
        self.lost.add(int(shard))
        if self.recovery is not None:
            self.recovery.fault(kind, int(shard))

    def kill(self, state, shard: int):
        """Zero one shard's table and stash rows (node gone, memory gone)."""
        state = _copied(state)
        state.table(shard).zero_()
        if state.stash_parts is not None:
            state.stash(shard).zero_()
        self._mark("kill", shard)
        return state

    def corrupt(self, state, shard: int, seed: int = 0):
        """Scramble one shard's table rows (the shard still answers,
        wrongly, until the control plane notices)."""
        rng = np.random.default_rng(seed)
        state = _copied(state)
        table = state.table(shard)
        words = rng.integers(0, 2**32, tuple(table.shape), dtype=np.uint32)
        table.copy_(torch.from_numpy(words.view(np.int32)))
        self._mark("corrupt", shard)
        return state

    def delay(self, fn: Callable, seconds: float) -> Callable:
        """Wrap ``fn`` with a fixed sleep (the straggler injector)."""
        @functools.wraps(fn)
        def slow(*a, **kw):
            time.sleep(seconds)
            return fn(*a, **kw)
        return slow

    def failing(self, fn: Callable, times: int) -> Callable:
        """Wrap ``fn`` to raise ``InjectedFault`` on its first ``times``
        calls, then pass through."""
        remaining = [times]

        @functools.wraps(fn)
        def flaky(*a, **kw):
            if remaining[0] > 0:
                remaining[0] -= 1
                raise InjectedFault(
                    f"injected failure ({remaining[0]} more)")
            return fn(*a, **kw)
        return flaky

    def heal(self, shard: int):
        self.lost.discard(int(shard))


def _copied(state):
    """A copy of a sharded state, each part on its own device."""
    return state._replace(
        table_parts=tuple(t.clone() for t in state.table_parts),
        stash_parts=(None if state.stash_parts is None
                     else tuple(s.clone() for s in state.stash_parts)))


# ------------------------------------------------- degraded-mode serving --


def degraded_lookup(mesh, axis: str, state, hi, lo, *, fp_bits: int,
                    injector: FaultInjector, route: str = "key",
                    capacity_factor: float = 2.0, backend: str = "auto",
                    recovery=None):
    """``distributed_lookup`` that survives lost shards
    -> (hits bool[N], overflow, degraded bool[N]) with numpy ``hits`` and
    ``degraded``.

    Every lane whose owner shard is in the injector's lost set answers True
    ("maybe present"), and ``degraded`` marks it; the surviving shards'
    answers are the healthy path's.  The owners are hashed where the
    answers gather (``hi``'s device); one host read returns both arrays.
    ``recovery.degraded`` counts the degraded answers.
    """
    from repro_torch.core.distributed import distributed_lookup
    hits, overflow = distributed_lookup(
        mesh, axis, state, hi, lo, fp_bits=fp_bits,
        capacity_factor=capacity_factor, backend=backend, route=route)
    n_shards = mesh.shape[axis]
    hi, lo = hi.to(hits.device), lo.to(hits.device)
    if route == "pair":
        nb = (state.n_buckets if state.n_buckets is not None
              else state.table(0).shape[0])
        owner = hashing.owner_shard_key_pair(hi, lo, nb, fp_bits, n_shards)
    else:
        owner = hashing.owner_shard(hi, lo, n_shards)
    lost = torch.tensor(sorted(injector.lost), dtype=owner.dtype,
                        device=owner.device)
    degraded = torch.isin(owner, lost)
    out, degraded = torch.stack([hits | degraded, degraded]).cpu().numpy()
    if recovery is not None:
        recovery.degraded(int(degraded.sum()))
    return out, overflow, degraded


def recover_shard(state, shard: int, *, ckpt_dir: str,
                  step: Optional[int] = None,
                  injector: Optional[FaultInjector] = None, recovery=None):
    """Re-populate one lost shard from the last durable snapshot.

    Grafts the snapshot's rows of ``shard`` (table and stash), read on the
    host, into a copy of the live state on the shard's own device; the
    other shards keep their CURRENT rows.  Heals the injector and reports
    the time to recover.  Keys the shard took after the snapshot are gone
    (upstream re-inserts them).
    """
    from repro_torch.checkpoint.ckpt import restore_sharded
    t0 = time.perf_counter()
    ctx = (recovery.span("recover_shard", shard=int(shard))
           if recovery is not None else _NULL)
    with ctx:
        snap = restore_sharded(ckpt_dir, step, device="cpu")
        new_state = _copied(state)
        new_state.table(shard).copy_(snap.table(shard))
        if new_state.stash_parts is not None:
            if snap.stash_parts is not None:
                new_state.stash(shard).copy_(snap.stash(shard))
            else:
                new_state.stash(shard).zero_()
        if injector is not None:
            injector.heal(shard)
    if recovery is not None:
        recovery.recovered("shard_restore", time.perf_counter() - t0)
    return new_state


class _NullCtx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()
