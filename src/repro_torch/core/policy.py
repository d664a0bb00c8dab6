"""OCF resize policies — the paper's §II contribution.

Capacity ``c`` is measured in item slots (= n_buckets × bucket_size), and
"time" is logical (number of marked operations), which is the only clock a
deterministic filter sees.  A copy of ``repro.core.policy`` (pure Python),
kept here so the port never imports the JAX package.

* ``PrePolicy``  (PRE, primitive): static thresholds.  ``O > O_max`` → double;
  ``O < O_min`` → ``c ← c − c/10``.  Bounded by user's ``[c_min, c_max]``.
* ``EofPolicy``  (EOF, congestion-aware): k-markers arm a monitoring window;
  on threshold crossing the rate ratio ``M = (c′·t′)/(c·t)`` updates the
  growth factor ``α ← α(1−g) + g·M`` (estimation gain ``g = 1/16`` default);
  grow ``c ← c + c·α``, shrink ``c ← c − c·(1−α)``.

Both policies apply the safety clamp ``c ≥ items/O_safe`` so a shrink can
never push occupancy past the safe load (the paper's observed false-negative
regime at load > 0.9); clamp events are counted for monitoring.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

O_SAFE = 0.95  # never allow a resize that would leave occupancy above this


@dataclasses.dataclass
class ResizeDecision:
    new_capacity: int
    reason: str          # "grow" | "shrink"
    alpha: float = 0.0   # EOF growth factor at decision time
    clamped: bool = False


@dataclasses.dataclass
class PrePolicy:
    """PRE mode: static-threshold resizing."""

    o_max: float = 0.85
    o_min: float = 0.25
    c_min: int = 1024
    c_max: int = 1 << 30

    unsafe_shrinks_prevented: int = 0

    def observe(self, *, items: int, capacity: int, ops: int = 1
                ) -> Optional[ResizeDecision]:
        occ = items / capacity
        if occ > self.o_max:
            target, reason = capacity * 2, "grow"
        elif occ < self.o_min and capacity > self.c_min:
            target, reason = capacity - capacity // 10, "shrink"
        else:
            return None
        new_c, clamped = _clamp(target, items, self.c_min, self.c_max)
        if reason == "shrink" and clamped:
            self.unsafe_shrinks_prevented += 1
        if new_c == capacity:
            return None
        return ResizeDecision(new_c, reason, clamped=clamped)


@dataclasses.dataclass
class EofPolicy:
    """EOF mode: congestion-aware resizing (paper Alg. 1)."""

    o_max: float = 0.85
    o_min: float = 0.25
    k_min: float = 0.35      # markers arm monitoring before thresholds hit
    k_max: float = 0.75
    gain: float = 1.0 / 16.0  # estimation gain g
    c_min: int = 1024
    c_max: int = 1 << 30

    alpha: float = dataclasses.field(default=None)  # type: ignore[assignment]
    monitoring: bool = False
    t_cur: int = 0            # marked ops in the current window
    c_window: int = 0         # capacity when the window was armed
    t_prev: int = 0           # previous window's length
    c_prev: int = 0           # previous window's capacity
    unsafe_shrinks_prevented: int = 0

    def __post_init__(self):
        if self.alpha is None:
            self.alpha = self.gain  # conservative seed; EWMA converges

    def observe(self, *, items: int, capacity: int, ops: int = 1
                ) -> Optional[ResizeDecision]:
        occ = items / capacity
        inside_markers = self.k_min <= occ <= self.k_max
        if not self.monitoring:
            if not inside_markers:
                # Arm the monitoring window; start marking operations.
                self.monitoring = True
                self.t_cur = 0
                self.c_window = capacity
            return None

        self.t_cur += ops
        if inside_markers:
            # Load receded between the markers: disarm without resizing.
            self.monitoring = False
            return None
        if self.o_min <= occ <= self.o_max:
            return None  # marked, still between hard thresholds

        # Hard threshold crossed: compute the rate ratio and resize.
        if self.t_prev > 0:
            m = (self.c_prev * self.t_prev) / max(1, self.c_window * self.t_cur)
        else:
            m = 1.0  # first resize: no history, neutral ratio
        self.alpha = self.alpha * (1.0 - self.gain) + self.gain * m
        a = min(max(self.alpha, 0.0), 1.0)
        if occ < self.o_max:   # paper Alg.1 line 5: shrink branch
            target, reason = int(capacity - capacity * (1.0 - a)), "shrink"
        else:
            target, reason = int(capacity + capacity * a), "grow"
        self.c_prev, self.t_prev = self.c_window, max(1, self.t_cur)
        self.monitoring = False
        new_c, clamped = _clamp(target, items, self.c_min, self.c_max)
        if reason == "shrink" and clamped:
            self.unsafe_shrinks_prevented += 1
        if new_c == capacity:
            return None
        return ResizeDecision(new_c, reason, alpha=a, clamped=clamped)


def _clamp(target: int, items: int, c_min: int, c_max: int) -> tuple[int, bool]:
    safe_floor = int(items / O_SAFE) + 1
    new_c = max(target, safe_floor, c_min)
    new_c = min(new_c, c_max)
    return new_c, new_c != target
