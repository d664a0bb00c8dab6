"""GQA/MQA attention (local window, soft-cap, qk-norm) with a KV cache.

Counterpart of the GQA half of ``repro.models.attention`` (``KVCache``,
``init_attention``, ``apply_attention``); MLA and cross-attention are not
ported.  ``apply_attention`` is cache-polymorphic like the reference's:

  * ``cache=None``: the full-sequence forward; attention goes to the flash
    kernel (``kernels.ops.attention``).
  * ``cache`` with ``cache_pos``: prefill or decode.  This step's k and v
    are written into the cache **in place** (the reference returns an
    updated copy; the port returns the same ``KVCache``, its tensors
    changed), and attention runs blockwise over the valid prefix (or, for a
    ``window``-long ring cache, over the ring with each slot's absolute
    position).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, Hkv, S, D]
    v: torch.Tensor  # [B, Hkv, S, D]


def init_attention(cfg: ModelConfig, *, generator, device) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo`` (+ ``q_norm``, ``k_norm``), in the
    reference's key order and shapes."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {}
    for name, shape in (("wq", (d, hq * hd)), ("wk", (d, hkv * hd)),
                        ("wv", (d, hkv * hd)), ("wo", (hq * hd, d))):
        p[name] = dense_init(shape, generator=generator, device=device)
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones(hd, device=device)
        p["k_norm"] = torch.ones(hd, device=device)
    return p


def apply_attention(p, cfg: ModelConfig, x: torch.Tensor, *, rot,
                    window: Optional[int] = None,
                    cache: Optional[KVCache] = None,
                    cache_pos: Optional[int] = None):
    """x: [B, S, E] -> ([B, S, E], cache or None).  ``rot``: the (cos,
    sin) of ``layers.rope_angles`` for this call's positions, [B, 1, S,
    head_dim / 2]."""
    b, sq, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p["wq"].to(x.dtype)).reshape(b, sq, hq, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, sq, hkv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, sq, hkv, hd)
    if cfg.use_qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q.transpose(1, 2), *rot)
    k = apply_rope(k.transpose(1, 2), *rot)
    v = v.transpose(1, 2)

    if cache is not None:
        klen = cache.k.shape[2]
        if window is not None and klen == window:
            # The window-bound ring: slot i holds absolute position
            # newest - ((newest - i) mod klen).  Of a write longer than the
            # ring only its last klen positions survive (the reference's
            # scatter leaves the same).
            w = min(sq, klen)
            idx = (cache_pos + torch.arange(sq - w, sq, device=x.device)) \
                % klen
            cache.k[:, :, idx] = k[:, :, sq - w:].to(cache.k.dtype)
            cache.v[:, :, idx] = v[:, :, sq - w:].to(cache.v.dtype)
            newest = cache_pos + sq - 1
            slot = torch.arange(klen, device=x.device)
            key_pos = newest - torch.remainder(newest - slot, klen)
            out = ops.attention(q, cache.k, cache.v, causal=True,
                                window=window,
                                logit_softcap=cfg.attn_logit_softcap,
                                scale=cfg.attn_scale, qpos_start=cache_pos,
                                key_positions=key_pos)
        else:
            cache.k[:, :, cache_pos:cache_pos + sq] = k.to(cache.k.dtype)
            cache.v[:, :, cache_pos:cache_pos + sq] = v.to(cache.v.dtype)
            out = ops.attention(q, cache.k, cache.v, causal=True,
                                window=window,
                                logit_softcap=cfg.attn_logit_softcap,
                                scale=cfg.attn_scale, qpos_start=cache_pos,
                                valid_len=cache_pos + sq)
    else:
        # v is a view of [B, S, Hkv, D]: the kernel reads it through its
        # strides.
        out = ops.attention(q, k, v, causal=True, window=window,
                            logit_softcap=cfg.attn_logit_softcap,
                            scale=cfg.attn_scale)
    out = out.transpose(1, 2).reshape(b, sq, hq * hd)
    return out @ p["wo"].to(x.dtype), cache
