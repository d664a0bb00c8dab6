"""RecurrentGemma / Griffin recurrent block: causal conv + RG-LRU.

Counterpart of ``repro.models.rglru`` (arXiv:2402.19427):

    r_t = sigmoid(W_a u_t + b_a)             recurrence gate
    i_t = sigmoid(W_x u_t + b_x)             input gate
    a_t = a ** (c * r_t),  a = sigmoid(Λ)    (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

No kernel: the reference computes it in XLA ops, the port in torch ops.
Without a cache the recurrence runs as a log-depth scan over the sequence
(Hillis-Steele doubling with the reference's combine ``(a1 a2, a2 b1 +
b2)``: ~13 elementwise passes at S = 8192; a step loop would launch per
token, and ``exp(cumsum(log a))`` underflows float32 over long
sequences); a prefill (a cache and S > 1) folds ``cache.h`` into step 0
of the same scan; a decode step (S = 1) is one update.  The gates, the
decay and the scan run in float32; the cache is written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, use_site_tp, zeros_init

_C = 8.0


class RglruCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv - 1, d_rnn]
    h: torch.Tensor      # [B, d_rnn]


def init_rglru(cfg: ModelConfig, *, generator, device) -> dict:
    """``w_in_rnn``, ``w_in_gate``, ``conv_w``, ``conv_b``, ``w_a``,
    ``b_a``, ``w_x``, ``b_x``, ``lam``, ``w_out`` in the reference's key
    order and shapes; Λ such that a = sigmoid(Λ)^c spans [0.9, 0.999]."""
    r = cfg.rglru
    d, dr = cfg.d_model, r.d_rnn

    def dense(shape):
        return dense_init(shape, generator=generator, device=device)
    p = {"w_in_rnn": dense((d, dr)), "w_in_gate": dense((d, dr)),
         "conv_w": dense((r.d_conv, dr)),
         "conv_b": zeros_init(dr, ("rnn",), device=device)[0],
         "w_a": dense((dr, dr)),
         "b_a": zeros_init(dr, ("rnn",), device=device)[0],
         "w_x": dense((dr, dr)),
         "b_x": zeros_init(dr, ("rnn",), device=device)[0]}
    y = torch.linspace(0.9, 0.999, dr) ** (1.0 / _C)
    p["lam"] = torch.log(y / (1.0 - y)).to(device)
    p["w_out"] = dense((dr, d))
    return p


def _conv(x, w, b, prev: Optional[torch.Tensor]):
    """Depthwise causal conv1d, no activation. x: [B, S, D]; w: [K, D] ->
    (out, the last K - 1 inputs)."""
    k, s = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], k - 1, x.shape[2])) if prev is None
           else prev.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    new_prev = xp[:, -(k - 1):] if k > 1 else None
    return out + b.to(x.dtype), new_prev


def _rglru_scan(x, a, *, h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + x_t over axis 1 (h_{-1} = ``h0``, else 0).
    x, a: [B, S, D]; h0: [B, D].  Pass k combines each step with the one
    2^k back, so after ceil(log2 S) passes step t holds the scan of 0..t."""
    if h0 is not None:
        # fold the initial state into the first step: x_0' = a_0 h0 + x_0
        x = torch.cat([(x[:, :1] + a[:, :1] * h0[:, None]), x[:, 1:]], dim=1)
    s = x.shape[1]
    shift = 1
    while shift < s:
        # (a, b) at t-shift, then (a, b) at t -> (a_{t-s} a_t,
        # a_t b_{t-s} + b_t)
        x = torch.cat([x[:, :shift],
                       torch.addcmul(x[:, shift:], a[:, shift:],
                                     x[:, :-shift])], dim=1)
        if 2 * shift < s:
            a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]],
                          dim=1)
        shift *= 2
    return x


def apply_rglru(p, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[RglruCache] = None, parallel=None):
    """Griffin recurrent block. x: [B, S, E] -> ([B, S, E], cache or
    None); with a cache, S > 1 is a prefill from ``cache.h`` and S = 1 a
    decode step, the cache written in place."""
    s = x.shape[1]

    def weight(name, dims, dt=x.dtype):
        return use_site_tp(p[name].to(dt), dims, parallel)
    gate = F.gelu(x @ weight("w_in_gate", (-1,)), approximate="tanh")
    u = x @ weight("w_in_rnn", (-1,))
    u, new_conv = _conv(u, p["conv_w"], p["conv_b"],
                        cache.conv if cache is not None else None)
    # column-parallel w_a / w_x: the only collective is the output's
    r = torch.sigmoid((u @ weight("w_a", (-1,), u.dtype)).float()
                      + p["b_a"].float())
    i = torch.sigmoid((u @ weight("w_x", (-1,), u.dtype)).float()
                      + p["b_x"].float())
    log_a = _C * r * F.logsigmoid(p["lam"].float())           # [B, S, D]
    a = torch.exp(log_a)
    gated = i * u.float()
    scaled = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                    min=1e-12)) * gated
    if cache is None:
        h = _rglru_scan(scaled, a)
    elif s == 1:
        h = a * cache.h.float()[:, None] + scaled             # decode step
    else:
        h = _rglru_scan(scaled, a, h0=cache.h.float())
    if cache is not None:
        cache.conv.copy_(new_conv)
        cache.h.copy_(h[:, -1])
    y = (h.to(x.dtype) * gate) @ weight("w_out", (-2,))
    return y, cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     stacked: tuple = (), device=None) -> RglruCache:
    """Zero conv window and state; ``stacked``: leading dims (a slot's
    layers)."""
    r = cfg.rglru
    return RglruCache(
        conv=torch.zeros((*stacked, batch, r.d_conv - 1, r.d_rnn),
                         dtype=dtype, device=device),
        h=torch.zeros((*stacked, batch, r.d_rnn), dtype=dtype,
                      device=device))
