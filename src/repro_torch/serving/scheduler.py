"""The serving front: the filter's wave submit path and the request
scheduler.

Counterpart of ``FilterOpBatcher`` (with ``OpWave``, ``BatcherStats`` and
``LATENCY_BUCKETS_US``) and of ``ContinuousBatcher`` (with ``Request`` and
``SchedStats``) in ``repro.serving.scheduler``.

**Filter waves.**  Membership ops arrive as *waves* of homogeneous keys
(lookups, inserts, deletes, reports of false positives).  One wave is
prepared on the host (lookup dedup, pad to a fixed shape, hash split, one
upload), dispatched to the device through ``FilterOps``, and harvested.
The harvest is the only host sync: one ``.cpu()`` of the wave's results,
the filter's count, the stash occupancy and (with telemetry on) the
counter plane, packed on the device first.  In double-buffered mode wave
k is harvested after wave k+1 has been prepared and dispatched, so host
prep overlaps the device's work.  Both modes issue the same device work
in the same order, so their results and the state they leave are equal
bit for bit.

Two dispatches do touch the host inside the device work: a report wave
(``kernels.selector.report_adapt`` is a host loop, as the reference's
sequential scan is) and a delete wave with a stash larger than
``kernels.stash.DENSE_DELETE_PAIRS`` allows densely.  Lookup and insert
waves, and delete waves of serving size, dispatch without a sync.

**Requests.**  ``ContinuousBatcher`` packs LM requests into a fixed number
of decode slots: a tick fills free slots from the queue (prefill, sample,
one token read), then queues every occupied slot's decode step and sample
with no host sync, and reads all of the tick's tokens in one stacked
transfer.  The OCF prefix index (``serving.kvcache``) counts the prefix
blocks a prompt could reuse, and a finished request publishes its
prompt's blocks.  Admission control can defer requests while the filter
is congested.

``DeferredWritePump`` and ``ShardedFilterFills`` of the reference's
scheduler, which drive the sharded filter, are not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.filter import FilterState
from repro_torch.core.scheduling import dedupe_keys
from repro_torch.kernels import ops as kops
from repro_torch.kernels.stash import stash_occupancy
from repro_torch.kernels.telemetry import (KICK_BINS, KICK_EDGES, OFFSET,
                                           PLANE_SIZE, PROBE_DEPTHS, pack)
from repro_torch.serving.engine import (greedy_sample, make_decode_step,
                                        make_prefill_step)
from repro_torch.serving.kvcache import PrefixCacheIndex

# Wave latency histogram edges (us) for the metrics registry.
LATENCY_BUCKETS_US = (50.0, 100.0, 200.0, 500.0, 1_000.0, 2_000.0,
                      5_000.0, 10_000.0, 25_000.0, 50_000.0, 100_000.0)


@dataclasses.dataclass
class OpWave:
    """One submitted wave and its timing.  ``latency_us`` spans offered ->
    results on the host, so a wave parked by admission control carries its
    queueing delay."""
    kind: str
    n: int
    submit_s: float
    done_s: float = 0.0
    deferred_ticks: int = 0       # submit ticks spent parked by admission
    results: Optional[np.ndarray] = None
    # harvest internals: the packed device tensor and how to slice it
    _device: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    _n_probe: int = 0
    _inverse: Optional[np.ndarray] = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def latency_us(self) -> float:
        return (self.done_s - self.submit_s) * 1e6


@dataclasses.dataclass
class BatcherStats:
    waves: int = 0                # waves offered via submit()
    ops: int = 0                  # real (non-padding) lanes offered
    harvests: int = 0
    deferred_waves: int = 0       # insert waves parked by admission
    held_ticks: int = 0           # drain attempts the gate held the queue
    shed_ops: int = 0             # lanes still parked when drain gave up
    deduped_lanes: int = 0        # lookup lanes collapsed by dedup


class FilterOpBatcher:
    """Double-buffered wave submit path over a ``FilterOps`` data plane.

    Works over either state family: ``core.filter.FilterState`` (with an
    optional overflow stash) through the static entry points, or
    ``adaptive.state.AdaptiveState`` (detected by its ``sels`` plane)
    through the selector-aware ones, plus the ``report`` kind.

    Waves are padded to ``wave_slots`` (key 0, ``valid=False``); a lookup
    wave probes only its own keys, so its probe-depth plane counts them
    alone (the reference's also counts the padding lanes).  ``submit``
    returns the ``OpWave`` at once; ``wave.results`` is filled
    at harvest: at the next submit (double-buffered) or before submit
    returns (sync).  ``flush()`` harvests the wave in flight.

    Admission: with an ``AdmissionController`` (or an ``AdmissionConfig``,
    from which one is built over this batcher's ``fills()``), insert waves
    are gated by its hysteresis signal; tripped inserts park in a deferred
    queue that retries on later submits and ``drain()``.  Lookups and
    deletes bypass the gate.  ``fills()`` is the occupancy read at the
    last harvest, so polling it costs no sync.

    ``double_buffer="auto"`` resolves from the state's device: always on a
    CUDA device, and on the CPU only with more than one core (one core is
    both host and "device", so a pipelined wave only queues).  The choice
    never changes a result.

    Observability (all off by default; off, the device work is that of a
    batcher built without them): ``telemetry`` dispatches through the
    ``FilterOps`` ``*_tm`` twins, whose ``FilterTelemetry`` comes back in
    the harvest's one transfer; ``metrics`` (a
    ``repro_torch.obs.MetricsRegistry``, made when ``telemetry`` is on and
    none is given) receives wave timings and counters; ``tracer`` (a
    ``repro_torch.obs.TraceRecorder``) gets dispatch and harvest spans.
    """

    def __init__(self, ops, state, *, stash: Optional[torch.Tensor] = None,
                 wave_slots: int = 512, double_buffer="auto",
                 dedupe_lookups: bool = True, admission=None,
                 clock: Callable[[], float] = time.perf_counter,
                 telemetry: bool = False, metrics=None, tracer=None):
        self.ops = ops
        self.state = state
        self.stash = stash
        self.device = state.table.device
        self.telemetry = bool(telemetry)
        if self.telemetry and metrics is None:
            from repro_torch.obs import MetricsRegistry
            metrics = MetricsRegistry()
        self.metrics = metrics
        self.tracer = tracer
        self.wave_slots = int(wave_slots)
        if double_buffer == "auto":
            double_buffer = (self.device.type != "cpu"
                             or (os.cpu_count() or 1) > 1)
        self.double_buffer = bool(double_buffer)
        self.dedupe_lookups = bool(dedupe_lookups)
        self._clock = clock
        self._adaptive = hasattr(state, "sels")
        self.capacity = int(state.n_buckets) * state.table.shape[1]
        self.stash_slots = 0 if stash is None else int(stash.shape[1])
        self._fill_snapshot = (
            float(state.count.cpu()) / max(1, self.capacity), 0.0)
        if admission is not None and not hasattr(admission, "admit"):
            from repro_torch.streaming.admission import AdmissionController
            admission = AdmissionController(filt=self, config=admission,
                                            metrics=self.metrics)
        self.admission = admission
        self._inflight: Optional[OpWave] = None
        self._deferred: deque[tuple[OpWave, np.ndarray]] = deque()
        self.stats = BatcherStats()

    # ----------------------------------------------------------- intake --

    def submit(self, kind: str, keys) -> OpWave:
        """Offer one wave -> its ``OpWave`` (results pending until harvest).

        Parked insert waves are retried (FIFO) before the new wave, so
        admission never reorders writes relative to each other."""
        keys = np.ascontiguousarray(np.asarray(keys, np.uint64))
        wave = OpWave(kind=kind, n=int(keys.size), submit_s=self._clock())
        self.stats.waves += 1
        self.stats.ops += wave.n
        self._retry_deferred()
        if (kind == "insert" and self.admission is not None
                and not self.admission.admit()):
            self._deferred.append((wave, keys))
            self.stats.deferred_waves += 1
            if self.metrics is not None:
                self.metrics.counter("filter_deferred_waves").inc()
            return wave
        self._launch(wave, keys)
        return wave

    def flush(self) -> None:
        """Harvest the wave in flight (one host sync)."""
        if self._inflight is not None:
            self._harvest(self._inflight)

    def drain(self, *, max_ticks: int = 100, on_held=None) -> int:
        """Retry parked waves until none remain (or ``max_ticks``), then
        flush -> number of ops still parked (shed).

        ``on_held``: called when the gate holds with nothing in flight to
        relieve it; without one the loop stops once holding makes no
        progress, and the remainder counts as shed."""
        for _ in range(max_ticks):
            if not self._deferred:
                break
            before = len(self._deferred)
            self._retry_deferred()
            if len(self._deferred) == before:
                self.stats.held_ticks += 1
                if self.metrics is not None:
                    self.metrics.counter("filter_held_ticks").inc()
                if on_held is None:
                    break
                on_held(self)
        self.flush()
        shed = sum(keys.size for _, keys in self._deferred)
        self.stats.shed_ops += shed
        if shed and self.metrics is not None:
            self.metrics.counter("filter_shed_ops").inc(shed)
        return shed

    def fills(self) -> tuple[float, float]:
        """(table fill, stash fill) at the LAST harvest: the fills() duck
        the admission controller reads, sync-free."""
        return self._fill_snapshot

    # --------------------------------------------------------- pipeline --

    def _retry_deferred(self) -> None:
        while self._deferred:
            if self.admission is not None and not self.admission.peek():
                for parked, _ in self._deferred:
                    parked.deferred_ticks += 1
                break
            wave, keys = self._deferred.popleft()
            self._launch(wave, keys)

    def _span(self, name: str, **args):
        """Trace span (or no-op): host-side only, never a device sync."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def _launch(self, wave: OpWave, keys: np.ndarray) -> None:
        prev = self._inflight
        with self._span("wave_dispatch", kind=wave.kind, n=wave.n):
            self._dispatch(wave, keys)   # overlaps prev's device work
        self._inflight = wave
        if prev is not None:
            self._harvest(prev)
        if not self.double_buffer:
            self._harvest(wave)

    def _prepare(self, wave: OpWave, keys: np.ndarray):
        """Host prep: dedup (lookups), pad, hash split, ONE upload."""
        if wave.kind == "lookup" and self.dedupe_lookups:
            keys, wave._inverse = dedupe_keys(keys)
            if wave._inverse is not None:
                self.stats.deduped_lanes += wave.n - keys.size
        n = keys.size
        if n > self.wave_slots:
            raise ValueError(f"a {wave.kind} wave of {n} keys exceeds "
                             f"wave_slots={self.wave_slots}")
        wave._n_probe = n
        padded = np.zeros(self.wave_slots, np.uint64)
        padded[:n] = keys
        buf = np.zeros((3, self.wave_slots), np.uint32)
        buf[0], buf[1] = hashing.key_to_u32_pair_np(padded)
        buf[2, :n] = 1
        host = torch.from_numpy(buf.view(np.int32))
        if self.device.type == "cuda":
            # Pinned, so the copy is queued on the stream like the kernels.
            dev = host.pin_memory().to(self.device, non_blocking=True)
        else:
            dev = host.to(self.device)
        return dev[0], dev[1], dev[2] != 0

    def _dispatch(self, wave: OpWave, keys: np.ndarray) -> None:
        """Queue the wave's device work and pack what the harvest reads
        (results, count, stash occupancy, counter plane) into one device
        tensor.  No host sync on this path (see the module docstring for
        the report wave)."""
        hi, lo, valid = self._prepare(wave, keys)
        ops, state, stash = self.ops, self.state, self.stash
        tm_on = self.telemetry
        tm = None
        out = None
        if wave.kind == "lookup":
            # Only the wave's keys: a padding lane (key 0) would be
            # answered, and counted by the probe-depth plane.
            hi, lo = hi[:wave._n_probe], lo[:wave._n_probe]
            if self._adaptive:
                fn = ops.lookup_adaptive_tm if tm_on else ops.lookup_adaptive
                out = fn(state, hi, lo, stash=stash)
            elif stash is not None:
                fn = (ops.lookup_with_stash_tm if tm_on
                      else ops.lookup_with_stash)
                out = fn(state, stash, hi, lo)
            else:
                out = (ops.lookup_tm if tm_on else ops.lookup)(state, hi, lo)
            res, tm = out if tm_on else (out, None)
        elif wave.kind == "insert":
            if self._adaptive:
                fn = ops.insert_adaptive_tm if tm_on else ops.insert_adaptive
                out = fn(state, hi, lo, valid=valid, stash=stash)
            elif stash is not None:
                fn = ops.insert_spill_tm if tm_on else ops.insert_spill
                out = fn(state, stash, hi, lo, valid=valid)
            else:
                fn = ops.insert_tm if tm_on else ops.insert
                out = fn(state, hi, lo, valid=valid)
        elif wave.kind == "delete":
            if self._adaptive:
                fn = ops.delete_adaptive_tm if tm_on else ops.delete_adaptive
                out = fn(state, hi, lo, valid=valid, stash=stash)
            elif stash is not None:
                out = self._delete_with_stash(state, stash, hi, lo, valid)
            else:
                fn = ops.delete_tm if tm_on else ops.delete
                out = fn(state, hi, lo, valid=valid)
        elif wave.kind == "report":
            if not self._adaptive:
                raise ValueError("'report' waves need an AdaptiveState")
            fn = (ops.report_false_positive_tm if tm_on
                  else ops.report_false_positive)
            out = fn(state, hi, lo, valid=valid)
            self.state, res = out[0], out[1]
            tm = out[3] if tm_on else None
        else:
            raise ValueError(f"unknown wave kind {wave.kind!r}")
        if wave.kind in ("insert", "delete"):
            if tm_on:
                out, tm = out[:-1], out[-1]
            self.state, res = out[0], out[-1]
            if stash is not None:
                self.stash = out[1]
        occ = (stash_occupancy(self.stash) if self.stash is not None
               else torch.zeros((), dtype=torch.int64, device=self.device))
        parts = [res.to(torch.int64), self.state.count.reshape(1),
                 occ.reshape(1)]
        if tm is not None:
            parts.append(pack(tm))
        wave._device = torch.cat(parts)

    def _delete_with_stash(self, state, stash, hi, lo, valid):
        """Static delete with a stash -> (state, stash, ok[, tm]): ``ok``
        counts table AND stash clears; ``count`` tracks the table."""
        kw = dict(n_buckets=state.n_buckets, valid=valid, stash=stash)
        if self.telemetry:
            table, new_stash, ok, tm = kops.filter_delete_tm(
                state.table, hi, lo, fp_bits=self.ops.fp_bits, **kw)
        else:
            table, new_stash, ok = self.ops.delete_table(state.table, hi, lo,
                                                         **kw)
        stash_cleared = stash_occupancy(stash) - stash_occupancy(new_stash)
        count = state.count - ok.sum() + stash_cleared
        out = (FilterState(table, count, state.n_buckets), new_stash, ok)
        return (*out, tm) if self.telemetry else out

    def _harvest(self, wave: OpWave) -> None:
        """The ONLY sync point: one transfer of the wave's packed tensor."""
        with self._span("wave_harvest", kind=wave.kind, n=wave.n):
            host = wave._device.cpu().numpy()
        n = host.size - 2 - (PLANE_SIZE if self.telemetry else 0)
        out = host[:wave._n_probe].astype(bool)
        count, occ = int(host[n]), int(host[n + 1])
        tm = host[n + 2:].tolist() if self.telemetry else None
        wave.results = (out[wave._inverse] if wave._inverse is not None
                        else out)
        wave._device = None
        wave.done_s = self._clock()
        self._fill_snapshot = (
            float(count) / max(1, self.capacity),
            float(occ) / self.stash_slots if self.stash_slots else 0.0)
        self.stats.harvests += 1
        if wave is self._inflight:
            self._inflight = None
        if self.metrics is not None:
            self._record_wave(wave, tm)

    # ------------------------------------------------------ observability --

    def _record_wave(self, wave: OpWave, tm) -> None:
        """Fold one harvested wave into the metrics registry.  ``tm`` is the
        wave's flat counter plane as a list of ints
        (``kernels.telemetry.pack``'s layout), or None without one."""
        m = self.metrics
        m.counter("filter_waves").inc(kind=wave.kind)
        m.counter("filter_wave_ops").inc(wave.n, kind=wave.kind)
        m.histogram("filter_wave_latency_us",
                    buckets=LATENCY_BUCKETS_US).observe(wave.latency_us,
                                                        kind=wave.kind)
        m.record_wave({"kind": wave.kind, "n": wave.n,
                       "latency_us": wave.latency_us,
                       "deferred_ticks": wave.deferred_ticks})
        if tm is None:
            return
        if wave.kind == "insert":
            m.histogram("filter_kick_depth",
                        buckets=KICK_EDGES).observe_counts(tm[:KICK_BINS])
        off = OFFSET["probe_depth"]
        for depth, cnt in zip(("b1", "b2", "stash", "miss"),
                              tm[off:off + PROBE_DEPTHS]):
            if cnt:
                m.counter("filter_probe_depth").inc(cnt, depth=depth)
        for field in ("stash_spills", "rollback_lanes", "selector_bumps",
                      "overflow_lanes", "table_deletes", "stash_deletes"):
            v = tm[OFFSET[field]]
            if v:
                m.counter("filter_" + field).inc(v)
        m.gauge("filter_stash_fill_hw").set_max(tm[OFFSET["stash_fill_hw"]])


# ------------------------------------------------ continuous batching ----


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    prefix_hit_blocks: int = 0


@dataclasses.dataclass
class SchedStats:
    admitted: int = 0
    finished: int = 0
    decode_steps: int = 0
    prefills: int = 0
    peak_queue: int = 0
    prefix_blocks_reused: int = 0
    wasted_slot_steps: int = 0    # decode steps with idle slots (burst gaps)
    deferred: int = 0             # requests parked by admission control
    shed_requests: int = 0        # requests dropped by backpressure policy


class ContinuousBatcher:
    """Fixed-slot continuous batcher over a per-slot KV cache.

    One cache per slot (a paged allocator would share pages across slots;
    the OCF index is the membership layer either way).  ``step()`` runs
    one scheduler tick: fill free slots from the queue (prefill), then one
    decode step over each occupied slot.
    """

    def __init__(self, model, *, slots: int = 4, cache_len: int = 512,
                 block: int = 32, dtype=torch.float32,
                 sample_fn: Optional[Callable] = None, index=None,
                 admission=None, backpressure=None):
        """``model``: a ``models.Transformer`` (it holds its weights).
        ``index``: any PrefixCacheIndex duck (e.g. the streaming
        ``GenerationalPrefixIndex``); defaults to the OCF-backed one on the
        model's device.  ``admission``: optional
        ``streaming.AdmissionController``: while its congestion signal is
        tripped, ``submit`` parks requests in ``deferred``.
        ``backpressure``: optional ``engine.BackpressureController``, a
        registry-fed admit / defer / shed policy consulted BEFORE the
        filter-side gate; ``shed`` drops the request (counted in
        ``stats.shed_requests``)."""
        self.model = model
        self.slots = slots
        self.cache_len = cache_len
        self.index = index if index is not None else PrefixCacheIndex(
            block=block, device=model.device)
        self.admission = admission
        self.backpressure = backpressure
        self.queue: deque[Request] = deque()
        self.deferred: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.pos = np.zeros(slots, dtype=np.int64)
        self.caches = [None] * slots
        self.stats = SchedStats()
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model)
        self._dtype = dtype
        self._sample = sample_fn or greedy_sample
        self._last_tok = [None] * slots

    # ------------------------------------------------------------ intake --

    def _enqueue(self, req: Request) -> None:
        self.queue.append(req)
        self.stats.admitted += 1
        self.stats.peak_queue = max(self.stats.peak_queue, len(self.queue))

    def submit(self, req: Request) -> bool:
        """Queue a request; False when admission control deferred it (it
        stays in ``deferred`` and re-enters on a later tick) or the
        backpressure policy shed it (dropped: the caller must retry)."""
        if self.backpressure is not None:
            decision = self.backpressure.decide()
            if decision == "shed":
                self.stats.shed_requests += 1
                return False
            if decision == "defer":
                self.deferred.append(req)
                self.stats.deferred += 1
                return False
        if self.admission is not None and not self.admission.admit():
            self.deferred.append(req)
            self.stats.deferred += 1
            return False
        self._enqueue(req)
        return True

    def _drain_deferred(self):
        """Re-admit parked requests while the congestion signal allows.

        One side-effect-free ``peek`` gates the whole drain: nothing here
        mutates the filter, so the signal (a device read) cannot change
        between requests, and polling does not inflate the controller's
        per-request counters.  A fully starved batcher (everything
        deferred, nothing queued or decoding) can never see the signal
        recede on its own, so it ages the filter: reclaim TTL-expired
        generations, else rotate; the next tick checks again.
        """
        if self.deferred and self.admission.peek():
            while self.deferred:
                self._enqueue(self.deferred.popleft())
        if self.deferred and not self.queue and not self.active:
            filt = self.admission.filt
            if not filt.advance():
                filt.rotate()

    @property
    def congestion(self) -> float:
        """Queue pressure (plus the filter's congestion when admission is
        wired): the EOF-style signal, in [0, inf)."""
        q = (len(self.queue) + len(self.deferred)) / max(1, self.slots)
        if self.admission is not None:
            q += self.admission.signal()
        return q

    # ------------------------------------------------------------- tick ---

    def _admit_one(self, slot: int, req: Request):
        hit = self.index.match_prefix(req.prompt)
        req.prefix_hit_blocks = hit
        self.stats.prefix_blocks_reused += hit
        cache = self.model.init_cache(1, self.cache_len, dtype=self._dtype)
        prompt = torch.from_numpy(np.asarray(req.prompt)).to(
            self.model.device)[None, :]
        logits, cache = self._prefill(cache, prompt)
        self.caches[slot] = cache
        self.pos[slot] = req.prompt.size
        self._last_tok[slot] = self._sample(logits)
        req.out.append(int(self._last_tok[slot][0, 0]))
        self.active[slot] = req
        self.stats.prefills += 1

    def step(self) -> int:
        """One scheduler tick -> the number of live requests decoded."""
        if self.admission is not None and self.deferred:
            self._drain_deferred()
        elif (self.deferred and self.backpressure is not None
                and self.backpressure.decide() == "admit"):
            while self.deferred:
                self._enqueue(self.deferred.popleft())
        for slot in range(self.slots):
            if slot not in self.active and self.queue:
                self._admit_one(slot, self.queue.popleft())
        # Dispatch: every occupied slot's decode and sample are queued on
        # the device with no host sync; the harvest below reads all of the
        # tick's tokens in ONE stacked transfer.
        ticked: list[tuple[int, Request]] = []
        toks = []
        for slot, req in list(self.active.items()):
            logits, cache = self._decode(self.caches[slot],
                                         self._last_tok[slot],
                                         int(self.pos[slot]))
            self.caches[slot] = cache
            self.pos[slot] += 1
            tok = self._sample(logits)
            self._last_tok[slot] = tok
            ticked.append((slot, req))
            toks.append(tok)
        if ticked:
            vals = torch.cat([t[:, 0] for t in toks]).cpu().numpy()
            for (slot, req), val in zip(ticked, vals):
                req.out.append(int(val))
                if len(req.out) >= req.max_new:
                    self.index.admit(req.prompt)  # publish prefix blocks
                    del self.active[slot]
                    self.caches[slot] = None
                    self.stats.finished += 1
        self.stats.decode_steps += 1
        self.stats.wasted_slot_steps += self.slots - len(ticked)
        return len(ticked)

    def run_until_drained(self, max_ticks: int = 10_000) -> SchedStats:
        ticks = 0
        while ((self.queue or self.active or self.deferred)
               and ticks < max_ticks):
            self.step()
            ticks += 1
        return self.stats


__all__ = ["BatcherStats", "ContinuousBatcher", "FilterOpBatcher",
           "LATENCY_BUCKETS_US", "OpWave", "Request", "SchedStats"]
