"""Mamba-2 mixer via SSD (state-space duality, arXiv:2405.21060).

Counterpart of ``repro.models.ssm``.  No kernel: the reference computes
the chunked dual form in XLA ops, and the port in torch ops (float32, as
the reference's).

  * Without a cache, and for a prefill (a cache and S > 1): the chunked
    form.  Within a chunk, attention-like products with a decay mask;
    across chunks a linear recurrence over the chunk summaries, a host
    loop of ``S / chunk`` steps (the reference's ``lax.scan``) that emits
    the state entering each chunk.  A prefill starts from ``cache.state``
    and writes the final state and the conv window into the cache.
  * Decode (a cache and S = 1): the one-step recurrence on the constant
    state [B, H, P, N] and the rolling conv window.

The chunk is ``min(cfg.ssm.chunk, S)``, and S must divide by it
(``ValueError``; the reference asserts).  Caches are written **in place**
(the reference returns an updated copy).  The products over the heads of
one B / C group are taken once per group and broadcast over its heads:
the same sums as the reference's per-head repeat.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import per_batch_shard, tp_matmul
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, silu, use_site_tp
from repro_torch.models.rglru import _conv


class SsmCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv - 1, conv_dim]  rolling conv input
    state: torch.Tensor  # [B, H, P, N]               SSM state


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, conv_dim


def init_ssm(cfg: ModelConfig, *, generator, device) -> dict:
    """``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``,
    ``norm``, ``out_proj`` in the reference's key order, shapes and init
    values (A = -[1 .. 16], dt between 1e-3 and 1e-1 through softplus)."""
    s, d_in, n_heads, conv_dim = _dims(cfg)
    d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + n_heads
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), n_heads))
    return {
        "in_proj": dense_init((cfg.d_model, d_proj), generator=generator,
                              device=device),
        "conv_w": dense_init((s.d_conv, conv_dim), generator=generator,
                             device=device),
        "conv_b": torch.zeros(conv_dim, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads)).to(device),
        "D": torch.ones(n_heads, device=device),
        "dt_bias": torch.log(torch.expm1(dt)).to(device),
        "norm": torch.ones(d_in, device=device),
        "out_proj": dense_init((d_in, cfg.d_model), generator=generator,
                               device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    _s, d_in, _h, conv_dim = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _causal_conv(xbc, w, b, *, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, then SiLU (RG-LRU's ``_conv`` has none).
    xbc: [B, S, C]; w: [K, C]; ``prev``: the last K - 1 inputs before xbc
    (zeros when None) -> (out [B, S, C], the last K - 1 inputs)."""
    out, new_prev = _conv(xbc, w, b, prev)
    return silu(out), new_prev


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < k <= i} x[..., k] on and below the
    diagonal, -inf above it."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, *, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD dual form. x: [b, s, h, p]; dt: [b, s, h]; A: [h]; B, C: [b, s,
    g, n] -> (y [b, s, h, p], final state [b, h, p, n]), in x's dtype.
    ``init_state`` [b, h, p, n]: the state entering the first chunk."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is no multiple "
                         f"of the chunk {chunk}")
    nc, rep = s // chunk, h // g
    xb = x.reshape(b, nc, chunk, h, p)
    dtb = dt.reshape(b, nc, chunk, h)
    Bg = B.reshape(b, nc, chunk, g, n)
    Cg = C.reshape(b, nc, chunk, g, n)

    dA = dtb * A                                       # [b, c, l, h]
    dA_cs = torch.cumsum(dA, dim=2)
    # within a chunk: attention-like products under the decay mask
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))     # [b, c, h, l, l]
    scores = torch.einsum("bclgn,bcsgn->bcgls", Cg, Bg)
    masked = (L.reshape(b, nc, g, rep, chunk, chunk)
              * scores[:, :, :, None]).reshape(b, nc, h, chunk, chunk)
    xdt = xb * dtb[..., None]                          # [b, c, l, h, p]
    y_diag = torch.einsum("bchls,bcshp->bclhp", masked, xdt)

    # chunk summaries, then the recurrence across chunks
    decay_last = torch.exp(dA_cs[:, :, -1:] - dA_cs)   # [b, c, l, h]
    xw = (xb * (decay_last * dtb)[..., None]).reshape(b, nc, chunk, g, rep,
                                                      p)
    states = torch.einsum("bclgn,bclgrp->bcgrpn", Bg, xw).reshape(
        b, nc, h, p, n)
    chunk_decay = torch.exp(dA_cs[:, :, -1])           # [b, c, h]
    state = (x.new_zeros((b, h, p, n)) if init_state is None
             else init_state.to(x.dtype))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(entering, dim=1).reshape(b, nc, g, rep, p, n)

    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cg, prev).reshape(
        b, nc, chunk, h, p) * torch.exp(dA_cs)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p), state


def apply_ssm(p, cfg: ModelConfig, x: torch.Tensor, *,
              cache: Optional[SsmCache] = None, parallel=None):
    """x: [B, S, E] -> ([B, S, E], cache or None).  With a cache: S > 1
    is a prefill from ``cache.state``, S = 1 a decode step; the cache is
    written in place and returned."""
    s_cfg, d_in, n_heads, _conv_dim = _dims(cfg)
    bsz, seq, _ = x.shape
    zxbcdt = tp_matmul(x, use_site_tp(p["in_proj"].to(x.dtype), (-1,),
                                      parallel))
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # [B, S, H]
    A = -torch.exp(p["A_log"].float())                        # [H]
    xbc_c, new_prev = _causal_conv(
        xbc, p["conv_w"], p["conv_b"],
        prev=cache.conv if cache is not None else None)
    gn = s_cfg.n_groups * s_cfg.d_state
    xs = xbc_c[..., :d_in].reshape(bsz, seq, n_heads, s_cfg.head_dim)
    B = xbc_c[..., d_in:d_in + gn].reshape(bsz, seq, s_cfg.n_groups,
                                           s_cfg.d_state)
    C = xbc_c[..., d_in + gn:].reshape(bsz, seq, s_cfg.n_groups,
                                       s_cfg.d_state)
    if cache is None or seq > 1:
        # one batch block a rank where the tensors are DTensors (the
        # dry-run): the chunked recurrence runs along the sequence
        def ssd(xs_, dt_, B_, C_, state_, A_):
            return ssd_chunked(xs_, dt_, A_, B_, C_,
                               chunk=min(s_cfg.chunk, seq),
                               init_state=state_)
        y, final = per_batch_shard(
            ssd, (xs.float(), dt, B.float(), C.float(),
                  cache.state if cache is not None else None), (A,))
    else:
        rep = n_heads // s_cfg.n_groups

        def step(xs_, dt_, B_, C_, state_, A_):
            Br = B_.repeat_interleave(rep, dim=2)[:, 0].float()  # [B, H, N]
            Cr = C_.repeat_interleave(rep, dim=2)[:, 0].float()
            dt1 = dt_[:, 0]                                     # [B, H]
            dA = torch.exp(dt1 * A_)
            xs1 = xs_[:, 0].float()                             # [B, H, P]
            final_ = (state_.float() * dA[..., None, None]
                      + torch.einsum("bhp,bhn->bhpn", xs1 * dt1[..., None],
                                     Br))
            return torch.einsum("bhpn,bhn->bhp", final_, Cr)[:, None], final_
        y, final = per_batch_shard(step, (xs, dt, B, C, cache.state), (A,))
    if cache is not None:
        cache.conv.copy_(new_prev)
        cache.state.copy_(final)
    # the skip term in [B, S, d_in] (each head's D over its P channels):
    # the same sums as over [B, S, H, P], without reshaping a sharded dim
    d_skip = p["D"].float().repeat_interleave(s_cfg.head_dim)
    y = (y.reshape(bsz, seq, d_in)
         + d_skip * xbc_c[..., :d_in].float()).to(x.dtype)
    y = rmsnorm(y * silu(z), p["norm"], cfg.rms_eps)
    return tp_matmul(y, use_site_tp(p["out_proj"].to(x.dtype), (-2,),
                                   parallel)), cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                   stacked: tuple = (), device=None) -> SsmCache:
    """Zero conv window and state; ``stacked``: leading dims (a slot's
    layers)."""
    s, _d_in, n_heads, conv_dim = _dims(cfg)
    return SsmCache(
        conv=torch.zeros((*stacked, batch, s.d_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((*stacked, batch, n_heads, s.head_dim, s.d_state),
                          dtype=dtype, device=device))
