"""Intra-block conflict ranking shared by the mutating kernels' plain
versions.

Counterpart of ``repro.kernels.rank``.  Every pass that writes the table
(insert placement rounds, eviction kicks, delete clears) serializes the
lanes of one logical block that target the same bucket:

    rank(i) = #active lanes j < i targeting the same bucket (and, for
              deletes, carrying the same fingerprint)

The CUDA kernels compute the same count per lane: the insert and delete
kernels with two count tables a round (``csrc/staged.cuh::rank_round``),
the adaptive ones by a loop over earlier lanes
(``csrc/ocf_common.cuh::rank_among_earlier``).
"""
from __future__ import annotations

import torch


def rank_among_earlier(target: torch.Tensor, active: torch.Tensor,
                       fp: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane conflict rank among earlier active lanes -> int64[N].

    An [N, N] broadcast-compare: N is one logical block (at most a few
    thousand lanes), so this stays small.
    """
    n = target.shape[0]
    lane = torch.arange(n, device=target.device)
    same = ((target[:, None] == target[None, :]) & active[None, :]
            & (lane[None, :] < lane[:, None]))
    if fp is not None:
        same &= fp[:, None] == fp[None, :]
    return same.sum(dim=1)
