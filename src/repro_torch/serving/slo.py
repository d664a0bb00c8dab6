"""Latency-SLO harness: closed-loop scenario replay with tail percentiles.

Counterpart of ``repro.serving.slo``.  A scenario stream
(``serving.workloads``) is replayed closed-loop against a live filter
stack through the wave-granular submit path
(``serving.scheduler.FilterOpBatcher``); every wave's offered -> results
span lands in a ``LatencyRecorder``, and the per-scenario ``SloReport``
folds the samples into p50 / p99 / p99.9 (with keys/s beside them, so a
tail is never read without its throughput).

The recorder keeps the raw per-wave records (kind, us, op count, tags) and
derives the summaries from them, so a report can be re-sliced (per kind,
in-burst vs gap, admitted vs deferred) without re-running the scenario.

Determinism: given one seed and one device, the stream, the filter state
trajectory and the sequence of device calls are pure functions of the seed
(``workloads.scenario_stream``), and the card and the CPU give the same
answers and states.

Warm-up: p99.9 over ~50 waves means nothing if wave 0 carries one-time
costs, so ``run_scenario`` first runs every kind the stream will touch on
a THROWAWAY same-shape stack.  On the card that takes the kernels' module
load, their first launches and the caching allocator's first growth out of
the timed replay; the timed stack is left untouched.

Stacks live on ``device`` (``"cuda"`` by default, which raises without a
card; tests pass ``"cpu"``, where the kernels' plain versions run).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np

from repro_torch.adaptive.state import make_adaptive_state
from repro_torch.core.filter import make_state
from repro_torch.core.filter_ops import FilterOps
from repro_torch.kernels.stash import make_stash
from repro_torch.serving.scheduler import FilterOpBatcher, OpWave
from repro_torch.serving.workloads import OpBatch, scenario_stream

__all__ = ["LatencyRecorder", "SloHarness", "SloReport", "WaveSample",
           "make_batcher", "run_scenario", "run_scenario_telemetry",
           "bench_scenarios", "BENCH_SCENARIOS", "PERCENTILES"]

PERCENTILES = (("p50", 50.0), ("p99", 99.0), ("p999", 99.9))

# Scenarios whose percentile rows ``bench_scenarios`` emits.
BENCH_SCENARIOS = ("uniform", "zipfian", "adversarial", "burst_train",
                   "ttl_churn", "delete_heavy")


@dataclasses.dataclass(frozen=True)
class WaveSample:
    """One wave's latency record: the raw unit the summaries derive from."""
    kind: str
    us: float        # offered -> results on the host, microseconds
    ops: int         # real lanes in the wave (percentiles are op-weighted)
    burst: bool = False
    deferred: bool = False   # spent >= 1 submit tick parked by admission


class LatencyRecorder:
    """Append-only per-wave samples and derived percentile summaries.

    Percentiles are **op-weighted**: a 512-key wave contributes 512
    identical per-op samples, so "p99 of ops" is the latency the
    99th-percentile *operation* saw, not the 99th-percentile wave.
    """

    def __init__(self):
        self.samples: list[WaveSample] = []

    def observe(self, kind: str, us: float, *, ops: int = 1,
                burst: bool = False, deferred: bool = False) -> None:
        self.samples.append(WaveSample(kind, float(us), int(ops),
                                       burst, deferred))

    def observe_wave(self, wave: OpWave, *, burst: bool = False) -> None:
        self.observe(wave.kind, wave.latency_us, ops=wave.n, burst=burst,
                     deferred=wave.deferred_ticks > 0)

    def _select(self, kinds=None, burst=None, exclude_deferred=False):
        out = self.samples
        if kinds is not None:
            out = [s for s in out if s.kind in kinds]
        if burst is not None:
            out = [s for s in out if s.burst == burst]
        if exclude_deferred:
            out = [s for s in out if not s.deferred]
        return out

    def ops(self, **sel) -> int:
        return sum(s.ops for s in self._select(**sel))

    def percentiles(self, **sel) -> dict[str, float]:
        """Op-weighted {p50, p99, p999} in us over the selected samples."""
        chosen = self._select(**sel)
        if not chosen:
            return {name: 0.0 for name, _ in PERCENTILES}
        us = np.repeat([s.us for s in chosen], [s.ops for s in chosen])
        return {name: float(np.percentile(us, q))
                for name, q in PERCENTILES}

    def kinds(self) -> list[str]:
        return sorted({s.kind for s in self.samples})


@dataclasses.dataclass
class SloReport:
    """One scenario's summary; ``rows()`` is the reference's
    ``BENCH_filter.json`` row shape."""
    scenario: str
    ops: int
    waves: int
    wall_s: float
    keys_per_s: float
    percentiles_us: dict[str, float]
    per_kind: dict[str, dict[str, float]]
    shed_ops: int = 0
    deferred_waves: int = 0
    held_ticks: int = 0
    extras: dict = dataclasses.field(default_factory=dict)
    # raw samples, for re-slicing (NOT part of rows())
    recorder: Optional[LatencyRecorder] = None

    def rows(self, prefix: Optional[str] = None) -> dict[str, float]:
        """Flat rows: ``slo_<scenario>_{p50,p99,p999}_us`` and
        ``slo_<scenario>_keys_per_s`` (and the extras verbatim)."""
        p = prefix or f"slo_{self.scenario}"
        out = {f"{p}_{name}_us": round(v, 1)
               for name, v in self.percentiles_us.items()}
        out[f"{p}_keys_per_s"] = int(self.keys_per_s)
        for k, v in self.extras.items():
            out[f"{p}_{k}"] = v
        return out


class SloHarness:
    """Closed-loop scenario replay over a submit path or generation ring.

    ``tracer``: optional ``repro_torch.obs.TraceRecorder``; each replay gets
    a scenario-level span (wave spans come from the batcher's own tracer;
    give both the same recorder for one timeline).
    """

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 tracer=None):
        self._clock = clock
        self.tracer = tracer

    def _span(self, name: str, **args):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    # ------------------------------------------------------ wave stacks --

    def run(self, batcher: FilterOpBatcher, stream: Iterable[OpBatch], *,
            scenario: str = "scenario", on_held=None) -> SloReport:
        """Replay ``stream`` through ``batcher``; every wave's latency is
        recorded at harvest.  ``feedback`` lookup waves close the adaptive
        loop: the harness flushes, gathers the hits, and submits them back
        as a ``report`` wave (a sample like any other: feedback is part of
        the serving path).

        Burst waves are timed from the **burst's arrival**, not from each
        wave's own submit call: a run of consecutive ``burst=True`` batches
        is one client offering the whole train at once, so every wave of
        the run shares the run's start time.  Otherwise the synchronous
        path would hide its queueing delay (it cannot submit wave k+1
        before wave k completes), while the double-buffered path exposes
        its device queue."""
        rec = LatencyRecorder()
        seen: list[tuple[OpWave, bool]] = []
        reported = 0
        burst_t0 = None
        t0 = self._clock()
        with self._span("scenario", scenario=scenario):
            for batch in stream:
                if not batch.burst:
                    burst_t0 = None
                elif burst_t0 is None:
                    burst_t0 = self._clock()  # the whole train arrives now
                wave = batcher.submit(batch.kind, batch.keys)
                if burst_t0 is not None:
                    wave.submit_s = burst_t0
                seen.append((wave, batch.burst))
                if batch.feedback:
                    batcher.flush()
                    hits = batch.keys[wave.results]
                    if hits.size:
                        seen.append((batcher.submit("report", hits), False))
                        reported += int(hits.size)
            batcher.drain(on_held=on_held)
        wall = self._clock() - t0
        for wave, burst in seen:
            if wave.done_s:        # shed waves never produced results
                rec.observe_wave(wave, burst=burst)
        return self._report(scenario, rec, wall, batcher=batcher,
                            extras={"reported_fps": reported}
                            if reported else {})

    # -------------------------------------------------- generation ring --

    def run_generational(self, filt, stream: Iterable[OpBatch], *,
                         scenario: str = "ttl_churn") -> SloReport:
        """Replay a TTL stream against a ``GenerationalFilter``.

        The ring's calls return host answers, so each wave is timed
        synchronously around its call."""
        rec = LatencyRecorder()
        now = 0.0
        t0 = self._clock()
        for batch in stream:
            now += batch.advance
            t1 = self._clock()
            if batch.kind == "insert":
                filt.insert(batch.keys, now=now)
            elif batch.kind == "lookup":
                filt.lookup(batch.keys, now=now)
            else:
                raise ValueError(
                    f"generation ring stream got {batch.kind!r}")
            rec.observe(batch.kind, (self._clock() - t1) * 1e6,
                        ops=batch.keys.size, burst=batch.burst)
        wall = self._clock() - t0
        extras = {"rotations": filt.stats.rotations,
                  "expirations": filt.stats.expirations}
        return self._report(scenario, rec, wall, extras=extras)

    # ---------------------------------------------------------- report --

    def _report(self, scenario: str, rec: LatencyRecorder, wall_s: float,
                *, batcher: Optional[FilterOpBatcher] = None,
                extras: Optional[dict] = None) -> SloReport:
        ops = rec.ops()
        report = SloReport(
            scenario=scenario, ops=ops, waves=len(rec.samples),
            wall_s=wall_s, keys_per_s=ops / wall_s if wall_s > 0 else 0.0,
            percentiles_us=rec.percentiles(),
            per_kind={k: rec.percentiles(kinds=(k,))
                      for k in rec.kinds()},
            extras=dict(extras or {}))
        if batcher is not None:
            report.shed_ops = batcher.stats.shed_ops
            report.deferred_waves = batcher.stats.deferred_waves
            report.held_ticks = batcher.stats.held_ticks
            if batcher.admission is not None:
                report.extras["peak_signal"] = round(
                    batcher.admission.peak_signal, 3)
        report.recorder = rec
        return report


# ----------------------------------------------------- scenario stacks --
#
# The reference's sizing per scenario, chosen so the steady-state load
# stays in the regime the scenario is about (moderate for the latency
# mixes, breathing across the hysteresis band for the admission arm).

_STATIC_STACKS = {
    "uniform": dict(n_buckets=4096),
    "zipfian": dict(n_buckets=4096),
    "burst_train": dict(n_buckets=2048, stash_slots=64),
    "delete_heavy": dict(n_buckets=2048),
}
_ADAPTIVE_STACKS = {
    # fp_bits=8 so the fixed adversarial pool yields false positives to
    # report (the latency of the feedback loop is the point).
    "adversarial": dict(n_buckets=2048, fp_bits=8),
}
_BUCKET_SIZE = 4


def make_batcher(scenario: str, *, device: str = "cuda",
                 wave_slots: int = 512, double_buffer="auto",
                 admission=None, n_buckets: Optional[int] = None,
                 stash_slots: Optional[int] = None, telemetry: bool = False,
                 metrics=None, tracer=None) -> FilterOpBatcher:
    """Fresh scenario-sized stack on ``device`` -> its ``FilterOpBatcher``."""
    if scenario in _ADAPTIVE_STACKS:
        cfg = dict(_ADAPTIVE_STACKS[scenario])
        nb = n_buckets or cfg["n_buckets"]
        state = make_adaptive_state(nb, _BUCKET_SIZE, device=device)
    else:
        cfg = dict(_STATIC_STACKS.get(scenario, {"n_buckets": 4096}))
        nb = n_buckets or cfg["n_buckets"]
        state = make_state(nb, _BUCKET_SIZE, device=device)
    ops = FilterOps(fp_bits=cfg.get("fp_bits", 16), schedule=True)
    slots = stash_slots if stash_slots is not None \
        else cfg.get("stash_slots", 128)
    stash = make_stash(slots, device=device) if slots else None
    return FilterOpBatcher(ops, state, stash=stash, wave_slots=wave_slots,
                           double_buffer=double_buffer, admission=admission,
                           telemetry=telemetry, metrics=metrics,
                           tracer=tracer)


def _warm_batcher(proto: FilterOpBatcher, kinds: Iterable[str]) -> None:
    """Run every kind the stream will touch on a throwaway same-shape
    stack (first launches, allocator growth), leaving ``proto``
    untouched."""
    nb, bs = int(proto.state.n_buckets), proto.state.table.shape[1]
    if hasattr(proto.state, "sels"):
        state = make_adaptive_state(nb, bs, device=proto.device)
    else:
        state = make_state(nb, bs, device=proto.device)
    stash = (make_stash(proto.stash.shape[1], device=proto.device)
             if proto.stash is not None else None)
    clone = FilterOpBatcher(proto.ops, state, stash=stash,
                            wave_slots=proto.wave_slots,
                            double_buffer=proto.double_buffer,
                            dedupe_lookups=proto.dedupe_lookups,
                            telemetry=proto.telemetry)
    keys = np.arange(1, proto.wave_slots + 1, dtype=np.uint64)
    for kind in ("insert", "lookup", "delete", "report"):
        if kind in kinds:
            clone.submit(kind, keys)
    clone.drain()


def _warm_generational(config) -> None:
    """Run the ring's insert and probe at every live generation count TTL
    churn will visit, on a throwaway ring of the same config."""
    from repro_torch.streaming.generations import GenerationalFilter
    gf = GenerationalFilter(config=config, now=0.0)
    for i in range(config.generations):
        keys = np.arange(1, 513, dtype=np.uint64) + np.uint64(i << 20)
        gf.insert(keys, now=0.0)
        gf.lookup(keys, now=0.0)
        gf.rotate(now=0.0)
    gf.lookup(np.arange(1, 513, dtype=np.uint64), now=0.0)


def run_scenario(name: str, *, seed: int = 0, device: str = "cuda",
                 double_buffer="auto", admission=None,
                 warmup: bool = True, wave_slots: int = 512,
                 stream_kwargs: Optional[dict] = None,
                 harness: Optional[SloHarness] = None,
                 telemetry: bool = False, metrics=None, tracer=None,
                 stack_kwargs: Optional[dict] = None) -> SloReport:
    """Run one scenario end to end on ``device`` -> its ``SloReport``.

    Everything downstream of (``name``, ``seed``, ``double_buffer``) is
    deterministic, and the same on every device.  ``telemetry`` routes
    the waves through the counter planes (answers unchanged);
    ``metrics`` / ``tracer`` receive the counters and spans.
    """
    stream = scenario_stream(name, seed,
                             wave_slots=wave_slots,
                             **(stream_kwargs or {}))
    harness = harness or SloHarness(tracer=tracer)
    if name == "ttl_churn":
        from repro_torch.streaming.generations import (GenerationalFilter,
                                                       GenerationConfig)
        cfg = GenerationConfig(generations=4, capacity=4096, fp_bits=16,
                               ttl=3.0, device=device)
        if warmup:
            _warm_generational(cfg)
        # now=0.0 pins the ring to the stream's logical clock: the epoch
        # the waves' ``advance`` deltas accumulate from.
        return harness.run_generational(
            GenerationalFilter(config=cfg, now=0.0, metrics=metrics),
            stream, scenario=name)
    batcher = make_batcher(name, device=device, wave_slots=wave_slots,
                           double_buffer=double_buffer, admission=admission,
                           telemetry=telemetry, metrics=metrics,
                           tracer=tracer, **(stack_kwargs or {}))
    if warmup:
        kinds = {b.kind for b in stream}
        if any(b.feedback for b in stream):
            kinds.add("report")
        _warm_batcher(batcher, kinds)
    return harness.run(batcher, stream, scenario=name)


def run_scenario_telemetry(name: str, out_dir: str = ".", *, seed: int = 0,
                           device: str = "cuda", double_buffer="auto",
                           admission=None) -> tuple[SloReport, dict]:
    """One scenario with counter planes and spans on, exported to files
    -> ``(report, paths)``:

    * ``slo_<name>_metrics.jsonl``: the registry's snapshot (kick-depth
      histogram, stash high-water, probe depths, admission transitions,
      wave timings and ring records), one JSON object a line;
    * ``slo_<name>_trace.json``: Chrome trace-event JSON (load it in
      ``ui.perfetto.dev``) with the dispatch and harvest spans of every
      wave.

    A lookup wave's probe-depth counts cover its own keys only (the
    reference's batcher also counts a short wave's padding lanes).
    """
    import os

    from repro_torch.obs import MetricsRegistry, TraceRecorder
    metrics = MetricsRegistry()
    tracer = TraceRecorder(process_name=f"slo:{name}")
    stack_kwargs = None
    if name == "burst_train" and admission is None:
        # The burst replay defaults to the admission arm of
        # ``bench_scenarios`` (a small stack and a hysteresis band the
        # bursts cross), so the snapshot carries the gate's transitions
        # beside the kernel counters.
        from repro_torch.streaming.admission import AdmissionConfig
        admission = AdmissionConfig(high_water=0.18, low_water=0.12)
        stack_kwargs = dict(n_buckets=1024, stash_slots=32)
        double_buffer = True
    report = run_scenario(name, seed=seed, device=device,
                          double_buffer=double_buffer, admission=admission,
                          telemetry=(name != "ttl_churn"), metrics=metrics,
                          tracer=tracer, stack_kwargs=stack_kwargs)
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "metrics": os.path.join(out_dir, f"slo_{name}_metrics.jsonl"),
        "trace": os.path.join(out_dir, f"slo_{name}_trace.json"),
    }
    metrics.to_jsonl(paths["metrics"])
    tracer.save(paths["trace"])
    report.extras["telemetry_files"] = paths
    return report, paths


def bench_scenarios(seed: int = 0, scenarios=BENCH_SCENARIOS, *,
                    device: str = "cuda") -> dict[str, float]:
    """The scenario x percentile matrix, as flat rows.

    The per-scenario rows use the default submit path
    (``double_buffer="auto"``: always double-buffered on the card;
    recorded in ``slo_submit_double_buffered``).  Beside them:

      * ``slo_burst_train_sync_*`` / ``slo_burst_train_async_*``: the
        burst train through both explicit submit paths (same seed, fresh
        stacks);
      * ``slo_burst_admission_*``: the burst train against a small stack
        with a hysteresis gate: the admitted ops' tail, the shed ops, the
        deferred waves and the peak signal;
      * ``slo_seed``: the seed the whole matrix derives from.
    """
    rows: dict[str, float] = {"slo_seed": seed}
    for name in scenarios:
        rows.update(run_scenario(name, seed=seed, device=device).rows())
    for arm, flag in (("sync", False), ("async", True)):
        rep = run_scenario("burst_train", seed=seed, device=device,
                           double_buffer=flag)
        for name, v in rep.percentiles_us.items():
            rows[f"slo_burst_train_{arm}_{name}_us"] = round(v, 1)
    rows["slo_submit_double_buffered"] = int(
        make_batcher("burst_train", device=device).double_buffer)
    # The admission arm, pinned to the double-buffered path: its fills()
    # snapshot lags one harvested wave, and the band is set against that
    # snapshot's trajectory (fill 0.25 at the base -> ~0.5 at the burst
    # tail).
    from repro_torch.streaming.admission import AdmissionConfig
    adm = make_batcher("burst_train", device=device,
                       n_buckets=1024, stash_slots=32, double_buffer=True,
                       admission=AdmissionConfig(high_water=0.18,
                                                 low_water=0.12))
    stream = scenario_stream("burst_train", seed)
    _warm_batcher(adm, {"insert", "lookup", "delete"})
    rep = SloHarness().run(adm, stream, scenario="burst_admission")
    admitted = rep.recorder.percentiles(exclude_deferred=True)
    rows["slo_burst_admission_p99_us"] = round(admitted["p99"], 1)
    rows["slo_burst_admission_shed_ops"] = rep.shed_ops
    rows["slo_burst_admission_deferred_waves"] = rep.deferred_waves
    rows["slo_burst_admission_peak_signal"] = rep.extras.get(
        "peak_signal", 0.0)
    return rows
