"""Quickstart of the PyTorch/CUDA port: the OCF in 60 seconds.

Creates an EOF-mode Optimized Cuckoo Filter (``repro_torch.core.OCF``),
pushes a bursty insert/delete workload through it, and prints the
capacity trajectory: grow under burst, shrink under churn, never lose a
key, block blind deletes.  On the card by default, on the CPU with
``--device cpu``:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.metrics import (measure_false_negatives,
                                      measure_false_positives)
from repro_torch.core.ocf import OCF, OcfConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=40_000)
    args = ap.parse_args()

    rng = np.random.RandomState(0)
    n = args.keys
    keys = rng.randint(0, 2 ** 63, size=n, dtype=np.int64).astype(np.uint64)
    ocf = OCF(OcfConfig(capacity=4096, mode="EOF", device=args.device))
    print(f"start: capacity={ocf.capacity} occupancy={ocf.occupancy:.3f}")

    # 1. bursty inserts: the filter resizes ahead of the traffic
    for i in range(0, n, 4096):
        ocf.insert(keys[i:i + 4096])
    print(f"after {n} burst inserts: capacity={ocf.capacity} "
          f"occupancy={ocf.occupancy:.3f} resizes={ocf.stats.resizes} "
          f"(grow={ocf.stats.grows})")

    # 2. correctness: zero false negatives, bounded false positives
    probes = rng.randint(0, 2 ** 63, size=n,
                         dtype=np.int64).astype(np.uint64)
    fn = measure_false_negatives(ocf, keys)
    print(f"false negatives: {fn} (must be 0)")
    print(f"false positives on {n} absent probes: "
          f"{measure_false_positives(ocf, probes)}")
    assert fn == 0, "a resident key was lost"

    # 3. blind deletes are verified against the keystore (paper §IV)
    foreign = rng.randint(0, 2 ** 63, size=1000,
                          dtype=np.int64).astype(np.uint64)
    ocf.delete(foreign)
    print(f"blind deletes blocked: {ocf.stats.blind_deletes_blocked}")
    assert ocf.stats.blind_deletes_blocked == foreign.size
    assert ocf.lookup(keys).all(), "no resident key was corrupted"

    # 4. delete churn: EOF shrinks the filter back down
    churn = n * 9 // 10
    for i in range(0, churn, 2048):
        ocf.delete(keys[i:min(i + 2048, churn)])
    print(f"after churn: capacity={ocf.capacity} "
          f"occupancy={ocf.occupancy:.3f} shrinks={ocf.stats.shrinks}")
    print(f"capacity history: {ocf.capacity_history}")
    assert ocf.stats.grows > 0 and ocf.stats.shrinks > 0
    assert ocf.lookup(keys[churn:]).all(), "a survivor was lost"


if __name__ == "__main__":
    main()
