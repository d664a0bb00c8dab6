"""Conflict-aware batch scheduling — the insert path's dispatch pre-pass.

Counterpart of ``repro.core.scheduling`` (``conflict_waves``,
``dispatch_order``, ``pair_rank``, ``wave_count``, ``dedupe_keys``).
Every lane's home bucket is ranked within its equal-bucket group: the k-th
lane targeting a bucket lands in wave k, and the batch is dispatched
wave-major.  Both sorts are stable, so same-bucket lanes keep their
relative order and the rank each lane sees in a placement round is
unchanged by the permutation.

Plain tensor code on both devices (the reference, too, ran it outside any
kernel): ``jnp.argsort(stable=True)`` becomes ``torch.sort(stable=True)``
and the ``associative_scan(maximum)`` becomes ``torch.cummax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing

# Invalid (padding) lanes park on a bucket id no real table reaches, so they
# sort behind every real lane and never split a wave.
_PARKED = 1 << 30


def _stable_order(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def conflict_waves(bucket: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Occurrence rank of each lane within its equal-bucket group
    -> int64[N]; invalid lanes get wave N."""
    n = bucket.shape[0]
    idx = torch.arange(n, device=bucket.device)
    b = torch.where(valid, bucket.to(torch.int64), _PARKED)
    order = _stable_order(b)
    sb = b[order]
    new_run = torch.ones((n,), dtype=torch.bool, device=bucket.device)
    new_run[1:] = sb[1:] != sb[:-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    wave = torch.empty_like(idx)
    wave[order] = idx - run_start
    return torch.where(valid, wave, n)


def pair_rank(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor
              ) -> torch.Tensor:
    """Occurrence rank within equal-``(a, b)`` groups -> int64[N].

    ``rank[i]`` counts earlier valid lanes carrying the same (a, b) pair as
    lane i, in lane order: two stable sorts (b-minor, then a-major) bring
    equal pairs into contiguous runs while ties keep lane order.  Values
    are compared as int32, like the reference.  Invalid lanes get rank N.
    """
    n = a.shape[0]
    idx = torch.arange(n, device=a.device)
    av = torch.where(valid, hashing.to_i32(a).to(torch.int64), _PARKED)
    bv = torch.where(valid, hashing.to_i32(b).to(torch.int64), _PARKED)
    ord1 = _stable_order(bv)                    # minor key ...
    order = ord1[_stable_order(av[ord1])]       # ... then major
    sa, sb = av[order], bv[order]
    new_run = torch.ones((n,), dtype=torch.bool, device=a.device)
    new_run[1:] = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    return torch.where(valid, rank, n)


def dispatch_order(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
                   *, n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Conflict-free-wave dispatch permutation -> (perm, inv), int64[N].

    ``perm`` reorders a batch wave-major (invalid lanes last); ``inv``
    scatters per-lane results back (``out[inv]``).
    """
    return dispatch_order_from_buckets(
        hashing.index_hash(hi, lo, n_buckets), valid)


def dispatch_order_from_buckets(i1: torch.Tensor, valid: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``dispatch_order`` for lanes whose home buckets ``i1`` are already
    hashed (the insert wrapper takes them from the fingerprint kernel)."""
    n = i1.shape[0]
    idx = torch.arange(n, device=i1.device)
    i1 = i1.to(torch.int64)
    b = torch.where(valid, i1, _PARKED)
    wave = conflict_waves(i1, valid)
    ord_b = _stable_order(b)                    # bucket-minor ...
    ord_w = _stable_order(wave[ord_b])          # ... then wave-major
    perm = ord_b[ord_w]
    inv = torch.empty_like(idx)
    inv[perm] = idx
    return perm, inv


def wave_count(i1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Number of conflict-free waves a batch schedules into -> int64[]
    (1: already conflict-free; K: some bucket is targeted by K lanes)."""
    if i1.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=i1.device)
    w = conflict_waves(i1, valid)
    return torch.where(valid, w + 1, 0).amax()


def dedupe_keys(keys: np.ndarray) -> tuple[np.ndarray, "np.ndarray | None"]:
    """Host-side lookup dedup -> (probe_keys, inverse-or-None).

    With in-batch repeats, ``probe_keys`` is the unique set and
    ``probe_keys[inverse] == keys``; with none, the keys come back as they
    are with ``inverse=None``.
    """
    keys = np.asarray(keys)
    uniq, inverse = np.unique(keys, return_inverse=True)
    if uniq.size == keys.size:
        return keys, None
    return uniq, inverse
