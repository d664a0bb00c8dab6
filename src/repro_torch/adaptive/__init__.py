"""Adaptive filtering: false-positive feedback, per-slot hash selectors,
and reputation-weighted admission (counterpart of ``repro.adaptive``).

Three tiers, cheapest first: the four-plane ``AdaptiveState`` with the
selector-aware kernels (a confirmed false positive is repaired in place);
``ReputationManager`` (repeat offenders go to an exact side table); and
``AdmissionController`` hysteresis gating cold report floods.
"""
from repro_torch.adaptive.filter import (AdaptiveConfig, AdaptiveFilter,
                                         split_keys)
from repro_torch.adaptive.reputation import (AdaptiveMembership,
                                             ReputationConfig,
                                             ReputationManager)
from repro_torch.adaptive.state import AdaptiveState, make_adaptive_state

__all__ = ["AdaptiveConfig", "AdaptiveFilter", "AdaptiveMembership",
           "AdaptiveState", "ReputationConfig", "ReputationManager",
           "make_adaptive_state", "split_keys"]
