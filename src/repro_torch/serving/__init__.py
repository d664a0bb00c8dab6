"""Serving: the prefix-cache indexes over the filters (``kvcache.py``) and
the LM engine (``engine.py``: prefill and decode steps, greedy sampling,
backpressure).  The scheduler, SLO harness and workloads are not ported
yet."""
from repro_torch.serving.engine import (BackpressureConfig,
                                        BackpressureController, generate,
                                        greedy_sample, make_decode_step,
                                        make_prefill_step)
from repro_torch.serving.kvcache import (GenerationalPrefixIndex,
                                         PrefixCacheIndex, PrefixStats,
                                         block_hashes)

__all__ = ["BackpressureConfig", "BackpressureController",
           "GenerationalPrefixIndex", "PrefixCacheIndex", "PrefixStats",
           "block_hashes", "generate", "greedy_sample", "make_decode_step",
           "make_prefill_step"]
