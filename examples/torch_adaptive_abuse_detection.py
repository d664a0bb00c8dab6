"""Adaptive filtering end to end on the PyTorch/CUDA port: an
abuse-detection denylist that learns.

A membership filter sits in front of an expensive ground-truth check: a
filter hit pays the slow path, a miss is served at once.  A classic
cuckoo filter keeps paying for the same colliding keys forever; the
adaptive filter (``repro_torch.adaptive``) takes each confirmed false
positive back through ``report``, bumps the colliding slot's hash
selector and rewrites its fingerprint from the mirrored resident key, so
the denylist never loses a member and the replayed query stops hitting.
On the card by default, on the CPU with ``--device cpu``:

    PYTHONPATH=src python examples/torch_adaptive_abuse_detection.py
"""
import argparse

import numpy as np

from repro_torch.adaptive import AdaptiveConfig, AdaptiveMembership


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flagged", type=int, default=6_000)
    ap.add_argument("--traffic", type=int, default=40_000)
    ap.add_argument("--n-buckets", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    rng = np.random.RandomState(7)
    flagged = np.unique(rng.randint(0, 2 ** 63, size=args.flagged,
                                    dtype=np.int64).astype(np.uint64))
    truth = set(int(k) for k in flagged)
    m = AdaptiveMembership(AdaptiveConfig(n_buckets=args.n_buckets,
                                          bucket_size=4, fp_bits=12,
                                          backend="auto",
                                          device=args.device))
    assert m.insert(flagged).all(), "denylist must fit"

    # one benign population queried every round: a static filter's false
    # positives are deterministic, so the same ids pay every round
    benign = np.unique(rng.randint(0, 2 ** 63, size=args.traffic,
                                   dtype=np.int64).astype(np.uint64))
    benign = benign[~np.isin(benign, flagged)]

    total_slow = 0
    for r in range(args.rounds):
        fps = benign[m.lookup(benign)]     # every benign hit: a slow path
        total_slow += fps.size
        assert all(int(k) not in truth for k in fps)
        adapted = m.report(fps)            # the ground truth refutes them
        print(f"round {r}: false positives={fps.size:4d} "
              f"(fp rate {fps.size / benign.size:.2e})  "
              f"adapted={int(adapted.sum()):4d}  "
              f"promoted={m.reputation.promoted:3d}")

    assert m.lookup(flagged).all(), "false negative on a denylisted account!"
    final_fp = int(m.lookup(benign).sum())
    print(f"\nslow-path lookups wasted across {args.rounds} rounds: "
          f"{total_slow}")
    print(f"steady-state false positives on the replayed population: "
          f"{final_fp} (static filter would repeat round 0 forever)")
    print(f"reputation tier: {m.reputation.promoted} ids promoted to the "
          f"exact side table, {m.deferred_reports} cold reports deferred")
    assert total_slow > 0, "the population must collide at first"
    assert final_fp == 0, "replayed population should be fully repaired"
    print("zero false negatives, replayed false positives fully repaired")


if __name__ == "__main__":
    main()
