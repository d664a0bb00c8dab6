"""Serving: the prefix-cache indexes over the filters (``kvcache.py``), the
LM engine (``engine.py``: prefill and decode steps, greedy sampling,
backpressure) and the filter's wave submit path (``scheduler.py``:
``FilterOpBatcher``).  The scheduler's ``ContinuousBatcher``,
``DeferredWritePump`` and ``ShardedFilterFills``, the SLO harness and the
workloads are not ported yet."""
from repro_torch.serving.engine import (BackpressureConfig,
                                        BackpressureController, generate,
                                        greedy_sample, make_decode_step,
                                        make_prefill_step)
from repro_torch.serving.kvcache import (GenerationalPrefixIndex,
                                         PrefixCacheIndex, PrefixStats,
                                         block_hashes)
from repro_torch.serving.scheduler import (LATENCY_BUCKETS_US, BatcherStats,
                                           FilterOpBatcher, OpWave)

__all__ = ["BackpressureConfig", "BackpressureController", "BatcherStats",
           "FilterOpBatcher", "GenerationalPrefixIndex",
           "LATENCY_BUCKETS_US", "OpWave", "PrefixCacheIndex", "PrefixStats",
           "block_hashes", "generate", "greedy_sample", "make_decode_step",
           "make_prefill_step"]
