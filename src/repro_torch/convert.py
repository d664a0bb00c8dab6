"""Carry filter state across from the reference as numpy arrays.

Tables and stashes cross as ``uint32`` numpy arrays (the reference's
dtype) and live here as ``int32`` tensors with the same bit pattern.
``ocf_from_numpy`` also loads the keystore (and, optionally, the policy,
stats and capacity history), so a port ``OCF`` can continue a stream
from the reference's state.  ``adaptive_state_from_numpy`` does the same
for the four planes of the adaptive filter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.adaptive.state import AdaptiveState
from repro_torch.core.filter import FilterState
from repro_torch.core.hashing import resolve_device
from repro_torch.core.ocf import OCF, OcfConfig, OcfStats


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def state_from_numpy(table: np.ndarray, count: int, n_buckets: int,
                     stash: Optional[np.ndarray] = None, *, device="cuda"
                     ) -> tuple[FilterState, Optional[torch.Tensor]]:
    """uint32 table [buf, b] (+ uint32 stash [2, S]) -> (state, stash)."""
    dev = resolve_device(device)
    state = FilterState(
        table=_tensor(table, dev),
        count=torch.tensor(int(count), dtype=torch.int64, device=dev),
        n_buckets=int(n_buckets))
    return state, None if stash is None else _tensor(stash, dev)


def state_to_numpy(state: FilterState, stash: Optional[torch.Tensor] = None
                   ) -> dict:
    """-> {"table": uint32[buf, b], "count": int, "n_buckets": int,
    "stash": uint32[2, S] or None}."""
    def u32(t):
        return t.detach().cpu().numpy().view(np.uint32).copy()
    return {"table": u32(state.table), "count": int(state.count),
            "n_buckets": int(state.n_buckets),
            "stash": None if stash is None else u32(stash)}


def adaptive_state_from_numpy(table: np.ndarray, sels: np.ndarray,
                              khi: np.ndarray, klo: np.ndarray, count: int,
                              n_buckets: int, *, device="cuda"
                              ) -> AdaptiveState:
    """uint32 planes (table, khi, klo [buf, b]; packed sels [buf, 1])
    -> ``AdaptiveState`` on ``device``."""
    dev = resolve_device(device)
    table = np.asarray(table)
    if np.asarray(sels).shape != (table.shape[0], 1) or any(
            np.asarray(p).shape != table.shape for p in (khi, klo)):
        raise ValueError("sels must be [buffer, 1] and khi/klo the table's "
                         "shape")
    return AdaptiveState(
        table=_tensor(table, dev), sels=_tensor(sels, dev),
        khi=_tensor(khi, dev), klo=_tensor(klo, dev),
        count=torch.tensor(int(count), dtype=torch.int64, device=dev),
        n_buckets=int(n_buckets))


def adaptive_state_to_numpy(state: AdaptiveState) -> dict:
    """-> {"table", "sels", "khi", "klo": uint32 arrays, "count": int,
    "n_buckets": int}."""
    def u32(t):
        return t.detach().cpu().numpy().view(np.uint32).copy()
    return {"table": u32(state.table), "sels": u32(state.sels),
            "khi": u32(state.khi), "klo": u32(state.klo),
            "count": int(state.count), "n_buckets": int(state.n_buckets)}


def ocf_from_numpy(config: OcfConfig, *, table: np.ndarray, count: int,
                   n_buckets: int, keys: np.ndarray,
                   stash: Optional[np.ndarray] = None,
                   policy: Optional[dict] = None,
                   stats: Optional[dict] = None,
                   capacity_history: Optional[list] = None) -> OCF:
    """An ``OCF`` holding the given filter state and keystore contents.

    ``keys`` lists every resident key with multiplicity (what the
    reference's ``keystore.materialize()`` returns).  ``policy`` and
    ``stats`` are field dicts (``dataclasses.asdict`` of the reference's
    objects); the policy must match ``config.mode``.
    """
    ocf = OCF(config)
    ocf.state, ocf.stash = state_from_numpy(table, count, n_buckets, stash,
                                            device=ocf.device)
    if (ocf.stash is None) != (config.stash_slots == 0):
        raise ValueError("stash given iff config.stash_slots > 0")
    ocf.keystore.add(np.asarray(keys, dtype=np.uint64))
    if policy is not None:
        fields = {f.name for f in dataclasses.fields(ocf.policy)}
        for name, value in policy.items():
            if name not in fields:
                raise ValueError(f"unknown policy field {name!r}")
            setattr(ocf.policy, name, value)
    if stats is not None:
        ocf.stats = OcfStats(**stats)
    if capacity_history is not None:
        ocf.capacity_history = list(capacity_history)
    return ocf
