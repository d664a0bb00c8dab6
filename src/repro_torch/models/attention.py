"""Attention mixers: GQA/MQA (local window, soft-cap, qk-norm) with a KV
cache, MLA (DeepSeek-V2 multi-head latent attention) with its latent
cache, and cross-attention over a conditioning memory.

Counterpart of ``repro.models.attention`` (``KVCache``,
``init_attention``, ``apply_attention``, ``init_mla``, ``apply_mla``,
``init_cross_attention``, ``apply_cross_attention``).  Both self-attention
apply functions are cache-polymorphic like the reference's:

  * ``cache=None``: the full-sequence forward; attention goes to the flash
    kernel (``kernels.ops.attention``; MLA's 192-wide q, k and 128-wide v
    reach it zero-padded to 256).
  * ``cache`` with ``cache_pos``: prefill or decode.  This step's k and v
    (MLA: its latent) are written into the cache **in place** (the
    reference returns an updated copy; the port returns the same
    ``KVCache``, its tensors changed), and attention runs blockwise over
    the valid prefix (or, for a ``window``-long ring cache, over the ring
    with each slot's absolute position).  MLA with at most 8 new tokens
    takes the reference's absorbed path: ``w_uk`` folded into the query,
    ``w_uv`` into the output, attention over the 576-wide latent itself.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor, split_last, tp_matmul
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, rmsnorm,
                                       use_site_tp)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, Hkv, S, D]  (MLA: [B, 1, S, lora + rope])
    v: torch.Tensor  # [B, Hkv, S, D]  (MLA: unused, [1, 1, 1])


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


def _ring_write(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    """dst[:, :, idx] = src, in place (``idx``: distinct slots).  A DTensor
    ring (sequence-sharded, the dry-run's) is written one block a rank:
    DTensor has no indexed write that keeps a sharded dim, so each rank
    sets the slots it holds (``_write_block``) from src laid out as dst
    but whole in the written dim."""
    src = src.to(dst.dtype)
    if not is_dtensor(dst):
        dst[:, :, idx] = src
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    src = src.redistribute(mesh, [
        Replicate() if isinstance(q, Shard) and q.dim == 2 else q
        for q in dst.placements]).to_local()
    _, offset = compute_local_shape_and_global_offset(dst.shape, mesh,
                                                      dst.placements)
    _write_block(dst.to_local(), offset[2], idx, src)


def _write_block(block: torch.Tensor, start: int, idx: torch.Tensor,
                 src: torch.Tensor):
    """The slots ``start ..`` of a ring that ``block`` holds, written in
    place: block[:, :, s] = src[:, :, j] where idx[j] == start + s."""
    slots = start + torch.arange(block.shape[2], device=idx.device)
    hit = idx[:, None] == slots[None, :]                 # [w, block slots]
    new = src.index_select(2, hit.int().argmax(0))
    block.copy_(torch.where(hit.any(0)[:, None], new, block))


def apply_attention(p, cfg: ModelConfig, x: torch.Tensor, *, rot,
                    window: Optional[int] = None,
                    cache: Optional[KVCache] = None,
                    cache_pos: Optional[int] = None, parallel=None):
    """x: [B, S, E] -> ([B, S, E], cache or None).  ``rot``: the (cos,
    sin) of ``layers.rope_angles`` for this call's positions, [B, 1, S,
    head_dim / 2]."""
    b, sq, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    def weight(name, dims):
        return use_site_tp(p[name].to(x.dtype), dims, parallel)
    q = split_last(tp_matmul(x, weight("wq", (-1,))), hq, hd)
    k = split_last(tp_matmul(x, weight("wk", (-1,))), hkv, hd)
    v = split_last(tp_matmul(x, weight("wv", (-1,))), hkv, hd)
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
            _ring_write(cache.k, idx, k[:, :, sq - w:])
            _ring_write(cache.v, idx, v[:, :, sq - w:])
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
    return tp_matmul(out, weight("wo", (-2,))), cache


# =============================================================== MLA ======


def init_mla(cfg: ModelConfig, *, generator, device) -> dict:
    """``wq``, ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wo``, in the
    reference's key order and shapes."""
    m, d, hq = cfg.mla, cfg.d_model, cfg.n_heads
    p = {"wq": dense_init((d, hq * (m.qk_nope_dim + m.qk_rope_dim)),
                          generator=generator, device=device),
         "w_dkv": dense_init((d, m.kv_lora_rank + m.qk_rope_dim),
                             generator=generator, device=device),
         "kv_norm": torch.ones(m.kv_lora_rank, device=device)}
    for name, shape in (("w_uk", (m.kv_lora_rank, hq * m.qk_nope_dim)),
                        ("w_uv", (m.kv_lora_rank, hq * m.v_head_dim)),
                        ("wo", (hq * m.v_head_dim, d))):
        p[name] = dense_init(shape, generator=generator, device=device)
    return p


def apply_mla(p, cfg: ModelConfig, x: torch.Tensor, *, rot,
              cache: Optional[KVCache] = None,
              cache_pos: Optional[int] = None, parallel=None):
    """x: [B, S, E] -> ([B, S, E], cache or None).  ``rot``: the (cos,
    sin) of ``layers.rope_angles`` at ``qk_rope_dim``, [B, 1, S,
    qk_rope_dim / 2].  The cache holds the normed latent and the rotated
    rope key, [B, 1, S_max, kv_lora + rope]; where it is float32 under
    bfloat16 activations, products with it run in float32, as the
    reference's type promotion has them."""
    m = cfg.mla
    b, sq, _ = x.shape
    hq, dt = cfg.n_heads, x.dtype
    nope, lora = m.qk_nope_dim, m.kv_lora_rank

    def weight(name, dims):
        return use_site_tp(p[name].to(dt), dims, parallel)
    q = split_last(tp_matmul(x, weight("wq", (-1,))), hq,
                   nope + m.qk_rope_dim)
    q_nope = q[..., :nope].transpose(1, 2)                  # [B, H, S, n]
    q_rope = apply_rope(q[..., nope:].transpose(1, 2), *rot)
    latent = tp_matmul(x, weight("w_dkv", ()))              # [B, S, l + r]
    c_kv = rmsnorm(latent[..., :lora], p["kv_norm"], cfg.rms_eps)
    k_rope = apply_rope(latent[..., None, lora:].transpose(1, 2), *rot)
    scale = (nope + m.qk_rope_dim) ** -0.5

    if cache is not None:
        cache.k[:, 0, cache_pos:cache_pos + sq] = torch.cat(
            [c_kv, k_rope[:, 0]], dim=-1).to(cache.k.dtype)
        hist = cache.k[:, 0]                                # [B, S_max, .]
        c_kv_all = hist[..., :lora]
        k_rope_all = hist[..., None, lora:].transpose(1, 2)  # [B, 1, S, r]
        at = dict(qpos_start=cache_pos, valid_len=cache_pos + sq)
    else:
        c_kv_all, k_rope_all, at = c_kv, k_rope, {}
    skv = c_kv_all.shape[1]

    if cache is not None and sq <= 8:
        # the absorbed path: attention against the latent cache itself
        w_uk = weight("w_uk", (-1,)).reshape(lora, hq, nope)
        q_lat = torch.einsum("bhqd,lhd->bhql", q_nope, w_uk)
        out_lat = ops.attention(torch.cat([q_lat, q_rope], dim=-1),
                                hist[:, None], c_kv_all[:, None],
                                causal=True, scale=scale, **at)
        w_uv = weight("w_uv", (-1,)).reshape(lora, hq, m.v_head_dim)
        out = torch.einsum("bhql,lhd->bhqd", out_lat, w_uv)
    else:
        ct = torch.promote_types(c_kv_all.dtype, dt)
        c_all = c_kv_all.to(ct)
        # column-parallel w_uk / w_uv over the latent made whole in its
        # sequence (a sequence-sharded cache's is gathered), one block a
        # rank (``tp_matmul``)
        k_nope = tp_matmul(c_all, weight("w_uk", (-1,)).to(ct)) \
            .reshape(b, skv, hq, nope).transpose(1, 2)
        vv = tp_matmul(c_all, weight("w_uv", (-1,)).to(ct)) \
            .reshape(b, skv, hq, m.v_head_dim).transpose(1, 2)
        k_rope_b = k_rope_all.expand(b, hq, skv, m.qk_rope_dim).to(dt)
        out = ops.attention(torch.cat([q_nope, q_rope], dim=-1),
                            torch.cat([k_nope, k_rope_b.to(ct)], dim=-1),
                            vv, causal=True, scale=scale, **at)
    out = out.transpose(1, 2).reshape(b, sq, hq * m.v_head_dim)
    return tp_matmul(out, weight("wo", (-2,))), cache


# ========================================================= cross-attn ====


def init_cross_attention(cfg: ModelConfig, *, generator, device) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo`` in the reference's key order and
    shapes; k and v project from ``cross_attn_memory_dim`` (else
    d_model)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    md = cfg.cross_attn_memory_dim or d
    return {name: dense_init(shape, generator=generator, device=device)
            for name, shape in (("wq", (d, hq * hd)), ("wk", (md, hkv * hd)),
                                ("wv", (md, hkv * hd)),
                                ("wo", (hq * hd, d)))}


def apply_cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                          memory: torch.Tensor) -> torch.Tensor:
    """x: [B, S, E]; memory: [B, M, memory_dim] -> [B, S, E].  The memory
    is taken in x's dtype (the flash kernel takes one dtype for q, k and
    v)."""
    b, sq, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    mem = memory.to(x.dtype)
    q = split_last(x @ p["wq"].to(x.dtype), hq, hd).transpose(1, 2)
    k = split_last(mem @ p["wk"].to(x.dtype), hkv, hd).transpose(1, 2)
    v = split_last(mem @ p["wv"].to(x.dtype), hkv, hd).transpose(1, 2)
    out = ops.attention(q, k, v, causal=False, window=None,
                        logit_softcap=None, scale=None)
    out = out.transpose(1, 2).reshape(b, sq, hq * hd)
    return out @ p["wo"].to(x.dtype)
