"""Observability: host metrics registry + trace spans.

Pure-Python copies of ``repro.obs`` (registry, trace, recovery), kept here
so the port never imports the JAX package; the trace recorder annotates
``torch.profiler`` traces instead of XLA ones.  The device counter planes
(the reference's ``kernels/telemetry.py``) are ``repro_torch.kernels.
telemetry``: the insert and probe kernels count them on the card, and
``serving.scheduler.FilterOpBatcher(telemetry=True)`` folds them into a
registry here.  Everything
here is optional-by-default: components accept ``metrics=None`` /
``tracer=None`` and do no observability work unless handed one.
"""
from repro_torch.obs.recovery import RecoveryMetrics
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, RingBuffer)
from repro_torch.obs.trace import TraceRecorder

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "RecoveryMetrics", "RingBuffer", "TraceRecorder"]
