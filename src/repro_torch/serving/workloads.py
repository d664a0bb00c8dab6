"""Deterministic closed-loop workload generators for the SLO harness.

Counterpart of ``repro.serving.workloads``, copied (numpy only): every
scenario, seed and keyword gives the reference's stream byte for byte.
Each generator turns one ``np.random.Generator`` into a deterministic
stream of ``OpBatch`` waves, the unit of work the serving submit path
(``serving.scheduler.FilterOpBatcher``) dispatches to the device.
Determinism is required twice over: percentile rows are compared across
commits (same seed, same key stream), and the double-buffered submit
path is held bit for bit against the synchronous one.

Every generator takes the rng as its first argument and derives all of
its randomness from it, so ``scenario_stream(name, seed)`` is
byte-reproducible.

Scenario catalog:

  * ``uniform``      — uniform key mix, ~50% hit-rate lookups + fresh
                       inserts; the baseline tail.
  * ``zipfian``      — rank-zipf lookups over a shuffled universe; hot
                       keys repeat within a wave, so the dedup pre-pass
                       (``core.scheduling.dedupe_keys``) carries the load.
  * ``adversarial``  — a fixed non-member pool replayed round after round
                       with ``feedback=True``: the harness reports every
                       hit back through ``report_false_positive`` (the
                       Adaptive Cuckoo Filters closed loop).
  * ``burst_train``  — insert bursts separated by lookup gaps, each burst
                       cleared by delete waves: the hysteresis-admission
                       story, and the arm the sync-vs-async rows run.
  * ``ttl_churn``    — TTL-aged churn against the generational ring:
                       every wave advances the logical clock, inserts are
                       fresh, lookups chase a sliding recency window.
  * ``delete_heavy`` — one delete wave per insert wave at steady state;
                       the delete kernel's tail, not just its throughput.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["OpBatch", "SCENARIOS", "scenario_stream"]

# Key 0 is reserved for padding lanes (``FilterOpBatcher`` pads waves to a
# fixed shape with key 0 + valid=False); generators never emit it.
_KEY_LOW, _KEY_HIGH = 1, np.uint64(2**63)


@dataclasses.dataclass(frozen=True)
class OpBatch:
    """One wave of homogeneous filter ops.

    ``kind``     — "lookup" | "insert" | "delete" | "report".
    ``keys``     — uint64[N], N <= the batcher's wave_slots.
    ``burst``    — wave belongs to a burst train (tagged in the recorder so
                   in-burst and gap tails can be split).
    ``advance``  — logical-clock delta applied BEFORE the wave (TTL
                   scenarios; 0.0 everywhere else).
    ``feedback`` — lookup wave whose hits the harness must report back as
                   confirmed false positives (closed-loop adversarial mix).
    """
    kind: str
    keys: np.ndarray
    burst: bool = False
    advance: float = 0.0
    feedback: bool = False


def _fresh(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(_KEY_LOW, _KEY_HIGH, size=n, dtype=np.uint64)


def _mix(rng: np.random.Generator, pools: list[np.ndarray],
         counts: list[int]) -> np.ndarray:
    """Concatenate ``counts[i]`` draws (with replacement) from each pool,
    shuffled together — a lookup wave with a controlled hit/miss blend."""
    parts = [rng.choice(p, size=c, replace=True) for p, c in zip(pools,
                                                                 counts)]
    keys = np.concatenate(parts)
    rng.shuffle(keys)
    return keys


# ------------------------------------------------------------ scenarios --


def uniform(rng: np.random.Generator, *, wave_slots: int = 512,
            waves: int = 48, write_frac: float = 0.25) -> list[OpBatch]:
    """Uniform mix: prefill a member set, then lookups (~50% hits) with a
    ``write_frac`` fraction of fresh-key insert waves."""
    members = _fresh(rng, 4 * wave_slots)
    stream = [OpBatch("insert", members[i:i + wave_slots])
              for i in range(0, members.size, wave_slots)]
    for _ in range(waves):
        if rng.random() < write_frac:
            stream.append(OpBatch("insert", _fresh(rng, wave_slots)))
        else:
            half = wave_slots // 2
            stream.append(OpBatch("lookup", _mix(
                rng, [members, _fresh(rng, half)], [wave_slots - half,
                                                    half])))
    return stream


def zipfian(rng: np.random.Generator, *, wave_slots: int = 512,
            waves: int = 48, a: float = 1.2,
            write_frac: float = 0.2) -> list[OpBatch]:
    """Rank-zipf lookups over a shuffled member universe: in-wave repeats
    of hot keys are the norm, which is exactly what the lookup dedup
    pre-pass collapses."""
    universe = _fresh(rng, 8 * wave_slots)
    stream = [OpBatch("insert", universe[i:i + wave_slots])
              for i in range(0, universe.size, wave_slots)]
    for _ in range(waves):
        if rng.random() < write_frac:
            stream.append(OpBatch("insert", _fresh(rng, wave_slots)))
        else:
            ranks = (rng.zipf(a, size=wave_slots) - 1) % universe.size
            stream.append(OpBatch("lookup", universe[ranks]))
    return stream


def adversarial(rng: np.random.Generator, *, wave_slots: int = 512,
                rounds: int = 4, pool_waves: int = 2) -> list[OpBatch]:
    """Adaptive-filter stressor: one fixed non-member pool replayed every
    round with ``feedback=True`` — each round's surviving false positives
    are reported back, so by construction the FP set should shrink round
    over round (the adaptive filter's feedback loop, with latency)."""
    members = _fresh(rng, 4 * wave_slots)
    pool = _fresh(rng, pool_waves * wave_slots)
    stream = [OpBatch("insert", members[i:i + wave_slots])
              for i in range(0, members.size, wave_slots)]
    for _ in range(rounds):
        for i in range(0, pool.size, wave_slots):
            stream.append(OpBatch("lookup", pool[i:i + wave_slots],
                                  feedback=True))
    return stream


def burst_train(rng: np.random.Generator, *, wave_slots: int = 512,
                bursts: int = 6, burst_waves: int = 4,
                gap_waves: int = 6) -> list[OpBatch]:
    """Insert bursts separated by lookup gaps, each burst deleted at the
    end of its gap — occupancy breathes up and down, the admission
    controller's hysteresis band gets crossed in both directions, and the
    sync-vs-async submit comparison runs on exactly this stream."""
    base = _fresh(rng, 2 * wave_slots)
    stream = [OpBatch("insert", base[i:i + wave_slots])
              for i in range(0, base.size, wave_slots)]
    for _ in range(bursts):
        burst_keys = []
        for _ in range(burst_waves):
            k = _fresh(rng, wave_slots)
            burst_keys.append(k)
            stream.append(OpBatch("insert", k, burst=True))
        transient = np.concatenate(burst_keys)
        half = wave_slots // 2
        for _ in range(gap_waves):
            stream.append(OpBatch("lookup", _mix(
                rng, [base, transient], [half, wave_slots - half])))
        for k in burst_keys:
            stream.append(OpBatch("delete", k))
    return stream


def ttl_churn(rng: np.random.Generator, *, wave_slots: int = 512,
              waves: int = 36, dt: float = 1.0,
              window: int = 4) -> list[OpBatch]:
    """Generational-ring churn: every wave advances the logical clock by
    ``dt``; inserts are always-fresh keys, lookups chase the last
    ``window`` insert waves (older keys age out of the ring and miss)."""
    recent: list[np.ndarray] = []
    stream: list[OpBatch] = []
    for w in range(waves):
        if w % 2 == 0:
            k = _fresh(rng, wave_slots)
            recent.append(k)
            recent[:] = recent[-window:]
            stream.append(OpBatch("insert", k, advance=dt))
        else:
            pool = np.concatenate(recent)
            stream.append(OpBatch(
                "lookup", rng.choice(pool, size=wave_slots, replace=True),
                advance=dt))
    return stream


def delete_heavy(rng: np.random.Generator, *, wave_slots: int = 512,
                 waves: int = 36) -> list[OpBatch]:
    """Steady-state churn with one delete wave per insert wave: the
    generator tracks residency host-side (pure python, still
    deterministic), so every delete wave targets keys that are actually
    resident."""
    resident = [_fresh(rng, wave_slots) for _ in range(4)]
    stream = [OpBatch("insert", k) for k in resident]
    for w in range(waves):
        r = w % 3
        if r == 0:
            k = _fresh(rng, wave_slots)
            resident.append(k)
            stream.append(OpBatch("insert", k))
        elif r == 1:
            victim = resident.pop(int(rng.integers(len(resident))))
            stream.append(OpBatch("delete", victim))
        else:
            pool = np.concatenate(resident)
            half = wave_slots // 2
            stream.append(OpBatch("lookup", _mix(
                rng, [pool, _fresh(rng, half)], [wave_slots - half, half])))
    return stream


SCENARIOS = {
    "uniform": uniform,
    "zipfian": zipfian,
    "adversarial": adversarial,
    "burst_train": burst_train,
    "ttl_churn": ttl_churn,
    "delete_heavy": delete_heavy,
}


def scenario_stream(name: str, seed: int = 0, **kwargs) -> list[OpBatch]:
    """Materialize scenario ``name`` from one seeded ``np.random.Generator``.

    The only rng entry point of the SLO harness: everything downstream
    (stream, filter state, and the answers on a given device) is a pure
    function of the seed.
    """
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have {sorted(SCENARIOS)})")
    return SCENARIOS[name](np.random.default_rng(seed), **kwargs)
