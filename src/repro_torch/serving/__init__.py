"""Serving: the prefix-cache indexes over the filters (``kvcache.py``), the
LM engine (``engine.py``: prefill and decode steps, greedy sampling,
backpressure), the serving front (``scheduler.py``: the filter's wave
submit path ``FilterOpBatcher`` and the request scheduler
``ContinuousBatcher``), the scenario workloads (``workloads.py``) and the
closed-loop latency harness (``slo.py``).  ``scheduler.py`` also holds the
sharded filter's deferred-write pump (``DeferredWritePump``, ``PumpStats``,
``ShardedFilterFills``)."""
from repro_torch.serving.engine import (BackpressureConfig,
                                        BackpressureController, generate,
                                        greedy_sample, make_decode_step,
                                        make_prefill_step)
from repro_torch.serving.kvcache import (GenerationalPrefixIndex,
                                         PrefixCacheIndex, PrefixStats,
                                         block_hashes)
from repro_torch.serving.scheduler import (LATENCY_BUCKETS_US, BatcherStats,
                                           ContinuousBatcher,
                                           DeferredWritePump, FilterOpBatcher,
                                           OpWave, PumpStats, Request,
                                           SchedStats, ShardedFilterFills)
from repro_torch.serving.slo import LatencyRecorder, SloHarness, SloReport
from repro_torch.serving.workloads import SCENARIOS, OpBatch, scenario_stream

__all__ = ["BackpressureConfig", "BackpressureController", "BatcherStats",
           "ContinuousBatcher", "DeferredWritePump", "FilterOpBatcher",
           "GenerationalPrefixIndex", "LATENCY_BUCKETS_US",
           "LatencyRecorder", "OpBatch", "OpWave", "PrefixCacheIndex",
           "PrefixStats", "PumpStats", "Request", "SCENARIOS", "SchedStats",
           "ShardedFilterFills", "SloHarness", "SloReport", "block_hashes",
           "generate", "greedy_sample", "make_decode_step",
           "make_prefill_step", "scenario_stream"]
