"""Admission control — stash + generation fill as a congestion signal.

A copy of ``repro.streaming.admission`` (pure Python over the port's
``core/policy.py``), kept here so the port never imports the JAX package.
The controller reads any filter with ``fills()``: the generation ring
(``streaming/generations.py``) and the adaptive tier
(``adaptive/reputation.py``), which gates its report floods with it.

The paper's burst story is a control loop: congestion must be *measured*
where it first appears and fed back to whatever admits work.  In the
streaming subsystem congestion appears in exactly two places, both cheap
device scalars:

  * **stash fill** — the overflow stash absorbs eviction-chain exhaustion,
    so its occupancy is a direct reading of how hard the active table is
    thrashing (it starts rising near the o_max operating point, well before
    inserts fail);
  * **generation fill** — the active table's occupancy, the same quantity
    the OCF's EOF policy integrates.

``congestion_signal`` folds the two into one [0, ~1] scalar;
``AdmissionController`` adds hysteresis (trip at ``high_water``, re-admit
below ``low_water``) so a burst sheds load without flapping; and
``observe_eof`` feeds the same signal to an ``EofPolicy`` by inflating its
marked-operation count — under congestion the EOF monitoring window closes
faster, which is precisely "resize ahead of the traffic".  The serving
scheduler (``serving/scheduler.py``) consumes the controller directly: its
admission queue defers requests while the controller is tripped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.policy import EofPolicy, PrePolicy, ResizeDecision


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    stash_weight: float = 0.6     # stash fill is the earlier indicator
    fill_weight: float = 0.4
    high_water: float = 0.85      # trip: stop admitting
    low_water: float = 0.60       # reset: admit again (hysteresis band)


def congestion_signal(stash_fill: float, gen_fill: float,
                      config: AdmissionConfig | None = None) -> float:
    """Weighted congestion scalar in [0, ~1] from the two device readings."""
    cfg = config or AdmissionConfig()
    return cfg.stash_weight * stash_fill + cfg.fill_weight * gen_fill


@dataclasses.dataclass
class AdmissionController:
    """Hysteresis gate over a congestion signal read from ``filt.fills()``.

    ``filt`` is any fills-duck — something with
    ``fills() -> (fill, stash_fill)`` in [0, 1] each.  In this package:
    ``streaming.generations.GenerationalFilter`` and
    ``adaptive.filter.AdaptiveFilter`` (live device reads); the reference
    also feeds it its serving batchers.

    ``last_signal`` / ``peak_signal`` record the most recent and worst
    congestion reading — the SLO report surfaces them so a burst scenario
    can show how close the gate came to (or how long it sat past) the
    high-water mark.
    """

    filt: object   # any fills() duck, see docstring
    config: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)
    tripped: bool = False
    admitted: int = 0
    deferred: int = 0
    last_signal: float = 0.0
    peak_signal: float = 0.0
    # Optional repro_torch.obs.MetricsRegistry: trip/readmit transitions
    # become counters, the congestion reading a pair of gauges.  None = free.
    metrics: Optional[object] = None
    # Hard gate for control-plane windows (elastic cutover): while frozen,
    # peek()/admit() answer False without reading the signal — the filter
    # state is mid-migration and fills() may straddle two meshes.
    frozen: bool = False

    def signal(self) -> float:
        """Current congestion in [0, ~1] (one stacked device read)."""
        fill, stash_fill = self.filt.fills()
        s = congestion_signal(stash_fill, fill, self.config)
        self.last_signal = s
        self.peak_signal = max(self.peak_signal, s)
        if self.metrics is not None:
            self.metrics.gauge("admission_signal").set(s)
            self.metrics.gauge("admission_peak_signal").set_max(s)
        return s

    def peek(self) -> bool:
        """Would a request be admitted right now?  Updates the hysteresis
        state but NOT the admitted/deferred counters — the side-effect-free
        form pollers (the scheduler's deferred-queue drain) must use, so
        the counters keep meaning *per-request decisions*."""
        if self.frozen:
            return False
        s = self.signal()
        if self.tripped:
            if s <= self.config.low_water:
                self.tripped = False
                if self.metrics is not None:
                    self.metrics.counter("admission_readmits").inc()
        elif s >= self.config.high_water:
            self.tripped = True
            if self.metrics is not None:
                self.metrics.counter("admission_trips").inc()
        return not self.tripped

    def freeze(self):
        """Deny all admissions until ``thaw`` — no signal read, no
        hysteresis transition.  The elastic controller brackets a migration
        window with freeze/thaw so nothing races the shard cutover."""
        self.frozen = True

    def thaw(self):
        self.frozen = False

    def admit(self) -> bool:
        """One per-request admission decision, with hysteresis + counters."""
        if self.peek():
            self.admitted += 1
            return True
        self.deferred += 1
        return False

    def observe_eof(self, policy: EofPolicy | PrePolicy, *, items: int,
                    capacity: int, ops: int = 1
                    ) -> Optional[ResizeDecision]:
        """Feed an OCF resize policy congestion-weighted marked ops.

        The EOF controller measures offered load by counting marked
        operations inside its monitoring window; scaling the count by
        ``1 + signal`` makes a congested stream close the window sooner, so
        the resize lands *ahead* of the burst (the paper's Alg. 1 intent,
        driven by the stash instead of switch-queue marks).
        """
        weighted = max(1, int(round(ops * (1.0 + self.signal()))))
        return policy.observe(items=items, capacity=capacity, ops=weighted)
