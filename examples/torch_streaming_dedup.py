"""Streaming dedup over a TTL window on the PyTorch/CUDA port.

A bursty event stream with heavy short-range duplication goes through a
``repro_torch.streaming.GenerationalFilter``: duplicates inside the TTL
window are dropped, eviction storms at high fill spill to the overflow
stash, whole generations age out at once, and the admission controller's
congestion signal rises and falls with the burst.  On the card by
default, on the CPU with ``--device cpu``:

    PYTHONPATH=src python examples/torch_streaming_dedup.py
"""
import argparse

import numpy as np

from repro_torch.streaming import (AdmissionConfig, AdmissionController,
                                   GenerationalFilter, GenerationConfig)

WINDOW = 60.0          # seconds an event stays deduplicated
TICKS = 24             # simulated seconds of stream


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--base", type=int, default=1500)    # events a tick
    ap.add_argument("--burst", type=int, default=6000)
    ap.add_argument("--capacity", type=int, default=1 << 13)
    args = ap.parse_args()

    rng = np.random.RandomState(0)
    gf = GenerationalFilter(GenerationConfig(
        generations=4, capacity=args.capacity, stash_slots=128, ttl=WINDOW,
        backend="auto", device=args.device), now=0.0)
    ctl = AdmissionController(gf, AdmissionConfig(high_water=0.7,
                                                  low_water=0.3))

    unique = dropped = 0
    seen_pool = None
    for t in range(TICKS):
        n = args.burst if 8 <= t < 12 else args.base    # a 4-second burst
        # ~40% of each tick repeats recent ids (the dedup target)
        fresh = rng.randint(0, 2 ** 63, size=int(n * 0.6),
                            dtype=np.int64).astype(np.uint64)
        pool = fresh if seen_pool is None else seen_pool
        repeats = rng.choice(pool, size=n - fresh.size, replace=True)
        events = np.concatenate([fresh, repeats])
        seen_pool = (fresh if seen_pool is None else
                     np.concatenate([seen_pool, fresh])[-20_000:])

        new = ~gf.lookup(events, now=float(t))   # all live generations
        gf.insert(events[new], now=float(t))     # burst overflow -> stash
        unique += int(new.sum())
        dropped += int((~new).sum())
        if t in (0, 7, 9, 11, 13, TICKS - 1):
            print(f"t={t:2d}  events={n:5d}  "
                  f"dedup_dropped={int((~new).sum()):5d}"
                  f"  fill={gf.fill:.2f}  stash_fill={gf.stash_fill:.2f}"
                  f"  signal={ctl.signal():.2f}  admit={ctl.admit()}")

    print(f"\nstream: {unique} unique, {dropped} duplicates dropped "
          f"({dropped / (unique + dropped):.1%} of traffic)")
    print(f"generations: rotations={gf.stats.rotations} "
          f"expirations={gf.stats.expirations} live={gf.live_generations}")
    print(f"stash: spills={gf.stats.spills} (burst overflow absorbed "
          f"on-device)")
    print(f"admission: admitted={ctl.admitted} deferred={ctl.deferred}")
    assert dropped > 0, "repeats inside the window must be dropped"
    # every event of the last tick is resident, inside the window
    assert gf.lookup(events, now=float(TICKS - 1)).all()

    # TTL: an hour later the whole window has aged out, without per-key
    # deletes, and the buffers go back to the pool
    assert not gf.lookup(seen_pool[:1000], now=3600.0).any()
    retired = gf.advance(now=3600.0)
    print(f"after TTL: {retired} generations retired, "
          f"window empty, pool recycled")


if __name__ == "__main__":
    main()
