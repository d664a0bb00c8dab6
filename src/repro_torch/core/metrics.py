"""Filter quality metrics (paper Table I quantities).

Counterpart of ``repro.core.metrics``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ocf import OCF


def theoretical_fp_rate(bucket_size: int, fp_bits: int,
                        occupancy: float) -> float:
    """eps = 1 - (1 - 1/2^f)^(2b*O), about 2b*O / 2^f for cuckoo filters."""
    return 1.0 - (1.0 - 2.0 ** (-fp_bits)) ** (2 * bucket_size * occupancy)


def measure_false_positives(ocf: OCF, probe_keys: np.ndarray) -> int:
    """Count positive answers for keys known to be absent from the keystore
    (ground truth from one vectorized keystore pass)."""
    probe_keys = np.asarray(probe_keys, dtype=np.uint64)
    absent = ~ocf.contains_keys_exact(probe_keys)
    hits = ocf.lookup(probe_keys)
    return int(np.sum(hits & absent))


def measure_false_negatives(ocf: OCF, inserted_keys: np.ndarray) -> int:
    """Must be 0 for any correct filter."""
    inserted_keys = np.asarray(inserted_keys, dtype=np.uint64)
    present = ocf.contains_keys_exact(inserted_keys)
    hits = ocf.lookup(inserted_keys)
    return int(np.sum(~hits & present))
