"""OCF core on PyTorch: hashing, state, data plane and control plane.

Counterpart of ``repro.core``, with the same package-level names but the
oracle ``PyCuckooFilter``, which the tests import from the reference."""
from repro_torch.core.filter import (FilterState, bulk_delete, bulk_insert,
                                     bulk_insert_hybrid, bulk_lookup,
                                     make_state, parallel_insert_once,
                                     rebuild)
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.keystore import VectorKeystore
from repro_torch.core.ocf import OCF, OcfConfig, OcfStats
from repro_torch.core.policy import EofPolicy, PrePolicy, ResizeDecision

__all__ = [
    "OCF", "OcfConfig", "OcfStats", "EofPolicy", "PrePolicy", "ResizeDecision",
    "FilterState", "FilterOps", "VectorKeystore", "make_state", "bulk_lookup",
    "bulk_insert", "bulk_delete", "bulk_insert_hybrid",
    "parallel_insert_once", "rebuild",
]
