"""Serving engine: prefill + decode step factories, a greedy driver, and
the backpressure policy over the metrics registry.

Counterpart of ``repro.serving.engine``.  The port's ``Transformer`` holds
its weights, so the steps take no ``params``; prefill and decode write the
cache in place and return it.  Both run blockwise attention over the cache
(``kernels.ops.attention``), as the reference's do: the flash kernel serves
the cache-less forward (prompt scoring).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.transformer import Transformer


def make_prefill_step(model: Transformer, parallel=None):
    """(cache, tokens[B,S], *, memory, prefix_embeds) -> (logits[B,S,V],
    cache); a prefix of P embeddings takes cache positions 0..P-1.
    ``parallel``: the sharding constraints' ``ParallelConfig``, as in the
    reference (they act on DTensors only)."""

    def prefill(cache, tokens, *, memory=None, prefix_embeds=None):
        out = model.apply(tokens, cache=cache, cache_pos=0, memory=memory,
                          prefix_embeds=prefix_embeds, parallel=parallel)
        return out.logits, out.cache

    return prefill


def make_decode_step(model: Transformer, parallel=None):
    """(cache, token[B,1], pos, *, memory) -> (logits[B,1,V], cache)."""

    def decode(cache, token, pos: int, *, memory=None):
        out = model.apply(token, memory=memory, cache=cache, cache_pos=pos,
                          parallel=parallel)
        return out.logits, out.cache

    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """int32 [B, 1]: the argmax of the last position (first on ties)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


# ------------------------------------------------- backpressure policy --


@dataclasses.dataclass(frozen=True)
class BackpressureConfig:
    """Thresholds over the registry's admission metrics.

    ``defer_signal`` / ``resume_signal`` form the hysteresis band over the
    ``admission_signal`` gauge (the congestion scalar the filter-side
    ``AdmissionController`` trips on); fresh ``filter_shed_ops`` escalate
    straight to shedding.
    """

    defer_signal: float = 0.85
    resume_signal: float = 0.60


class BackpressureController:
    """Three-state admit/defer/shed decision over a metrics registry.

    Reads (never writes) the congestion metrics the filter stack
    publishes: the ``admission_signal`` / ``admission_peak_signal`` gauges,
    and the ``filter_deferred_waves`` and ``filter_shed_ops`` counters.

      admit --(deferred waves grow OR signal >= defer_signal)--> defer
      any   --(fresh shed ops)-----------------------------------> shed
      defer/shed --(signal <= resume_signal, no new evidence)----> admit

    Counter deltas (not absolutes) drive the transitions, so a controller
    attached mid-run does not re-punish historical congestion.
    """

    def __init__(self, metrics, config: Optional[BackpressureConfig] = None):
        self.metrics = metrics
        self.config = config or BackpressureConfig()
        self.state = "admit"
        self._last = {"filter_shed_ops": self._read("filter_shed_ops"),
                      "filter_deferred_waves":
                          self._read("filter_deferred_waves")}

    def _read(self, name: str) -> float:
        return float(self.metrics.counter(name).value())

    def _delta(self, name: str) -> float:
        cur = self._read(name)
        d = cur - self._last[name]
        self._last[name] = cur
        return d

    @property
    def peak_signal(self) -> float:
        return float(self.metrics.gauge("admission_peak_signal").value())

    def decide(self) -> str:
        """One backpressure decision -> 'admit' | 'defer' | 'shed'."""
        cfg = self.config
        sig = float(self.metrics.gauge("admission_signal").value())
        shed = self._delta("filter_shed_ops")
        deferred = self._delta("filter_deferred_waves")
        if shed > 0:
            self.state = "shed"
        elif self.state == "shed":
            if sig <= cfg.resume_signal and deferred == 0:
                self.state = "admit"
        elif deferred > 0 or sig >= cfg.defer_signal:
            self.state = "defer"
        elif self.state == "defer" and sig <= cfg.resume_signal:
            self.state = "admit"
        self.metrics.counter("backpressure_decisions").inc(
            decision=self.state)
        return self.state


@dataclasses.dataclass
class GenerationResult:
    tokens: Any
    steps: int


def generate(model: Transformer, prompt, max_new: int, *, memory=None,
             prefix_embeds=None, cache_len: Optional[int] = None,
             dtype=torch.float32) -> GenerationResult:
    """Batched greedy generation (prefill + decode loop); ``memory`` goes
    to every step, ``prefix_embeds`` [B, P, E] before the prompt (the
    cache then holds P + S + max_new positions)."""
    prompt = torch.as_tensor(prompt, device=model.device)
    b, s = prompt.shape
    s += 0 if prefix_embeds is None else prefix_embeds.shape[1]
    cache = model.init_cache(b, cache_len or (s + max_new), dtype=dtype)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(cache, prompt, memory=memory,
                            prefix_embeds=prefix_embeds)
    tok = greedy_sample(logits)
    toks = [tok]
    for pos in range(s, s + max_new - 1):
        logits, cache = decode(cache, tok, pos, memory=memory)
        tok = greedy_sample(logits)
        toks.append(tok)
    return GenerationResult(tokens=torch.cat(toks, dim=1), steps=max_new)
