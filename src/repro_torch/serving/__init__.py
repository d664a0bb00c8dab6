"""Serving-side indexes over the filters.  So far only the prefix-cache
indexes (``kvcache.py``); the scheduler, SLO harness and engine need the
model stack and are not ported yet."""
from repro_torch.serving.kvcache import (GenerationalPrefixIndex,
                                         PrefixCacheIndex, PrefixStats,
                                         block_hashes)

__all__ = ["GenerationalPrefixIndex", "PrefixCacheIndex", "PrefixStats",
           "block_hashes"]
