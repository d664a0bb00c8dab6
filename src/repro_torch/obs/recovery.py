"""Recovery observability: one facade over registry + tracer for the
fault/elastic control plane.

A copy of ``repro.obs.recovery``, kept so the port never imports the JAX
package.

The elastic controller, fault injector, and recovery path all want the same
small vocabulary — keys migrated, rounds streamed, time-to-recover,
degraded-window answers, deferred backlog — and the bench gate wants those
names STABLE (it greps the exported JSONL for ``elastic_*`` rows).  This
module is that vocabulary: every producer calls one semantic method, and
the method fans out to the right counter/gauge/span so no producer
hand-rolls metric names.

Metric schema (all through one ``MetricsRegistry``):

  counters
    ``elastic_keys_migrated{direction}``      fingerprints shipped
    ``elastic_migration_rounds{direction}``   all_to_all rounds
    ``elastic_migration_failed{direction}``   lanes lost to full receivers
    ``elastic_backlog_drained_lanes``         parked writes replayed
    ``degraded_lookup_answers``               conservative "maybe" answers
    ``shard_faults{kind}``                    injected kill/corrupt/delay
  gauges
    ``elastic_migration_seconds{direction}``  migration wall time
    ``elastic_time_to_recover_s{event}``      hold -> recovered, per event
    ``elastic_deferred_backlog``              lanes still parked

Spans (``elastic_split`` / ``elastic_merge`` / ``recover_shard`` /
``pump_resubmit``) ride the same ``TraceRecorder`` the serving batcher
uses, so a migration shows up on the one timeline next to the waves it
displaced.  Like every obs consumer in the repo: ``metrics=None`` /
``tracer=None`` makes every method a no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass
class RecoveryMetrics:
    """Recovery-event recorder over an optional registry + tracer."""

    metrics: Optional[object] = None    # repro_torch.obs.MetricsRegistry
    tracer: Optional[object] = None     # repro_torch.obs.TraceRecorder

    def span(self, name: str, **args):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def fault(self, kind: str, shard: int) -> None:
        """An injected (or detected) shard fault: kill/corrupt/delay."""
        if self.metrics is not None:
            self.metrics.counter("shard_faults").inc(kind=kind)
        if self.tracer is not None:
            self.tracer.instant(f"fault_{kind}", shard=shard)

    def degraded(self, n: int) -> None:
        """``n`` lookups answered conservatively during a degraded window."""
        if n and self.metrics is not None:
            self.metrics.counter("degraded_lookup_answers").inc(n)

    def migration(self, direction: str, *, keys: int, rounds: int,
                  failed: int, seconds: float) -> None:
        """One completed split/merge — the MigrationReport, as metrics."""
        if self.metrics is None:
            return
        m = self.metrics
        m.counter("elastic_keys_migrated").inc(keys, direction=direction)
        m.counter("elastic_migration_rounds").inc(rounds,
                                                  direction=direction)
        m.counter("elastic_migration_failed").inc(failed,
                                                  direction=direction)
        m.gauge("elastic_migration_seconds").set(seconds,
                                                 direction=direction)

    def recovered(self, event: str, seconds: float) -> None:
        """Time-to-recover for one event (elastic_split, shard_restore...)."""
        if self.metrics is not None:
            self.metrics.gauge("elastic_time_to_recover_s").set(
                seconds, event=event)
        if self.tracer is not None:
            self.tracer.instant("recovered", event=event, seconds=seconds)

    def backlog(self, pending: int) -> None:
        """Deferred-write backlog still parked (0 == fully drained)."""
        if self.metrics is not None:
            self.metrics.gauge("elastic_deferred_backlog").set(pending)

    def drained(self, lanes: int) -> None:
        """Parked lanes replayed through the pump after a cutover."""
        if lanes and self.metrics is not None:
            self.metrics.counter("elastic_backlog_drained_lanes").inc(lanes)
