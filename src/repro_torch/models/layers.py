"""Shared layer primitives of the LM stack.

Counterpart of ``repro.models.layers``.  Parameters keep the reference's
shapes (``[in, out]`` weights, ``x @ w``) and dtype (float32), and every
function casts where the reference casts, so that the same weights give the
same logits within rounding: ``rmsnorm`` and ``rope`` compute in float32
and cast back, ``embed`` takes the table in the activation dtype and scales
by ``sqrt(d_model)`` rounded to that dtype (34.0 for gemma3-1b in
bfloat16), ``unembed`` returns float32 logits after the final soft-cap.
``use_site_tp`` is the reference's use-site constraint: on a DTensor
weight (the dry-run's) a ``redistribute`` to TP-only sharding, a no-op on
a plain tensor or without a mesh.  The logical axis names of every weight
are ``launch.specs.LOGICAL_SPECS``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (is_dtensor, row_parallel_head,
                                              to_placements, tp_matmul)
from repro_torch.models.config import ModelConfig


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype ``cfg.dtype`` names."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ------------------------------------------------------------------ init ---


def use_site_tp(w, tp_dims: tuple, parallel):
    """Constrain a weight at its use site to TP-only sharding.

    A resident weight is FSDP-sharded (an axis over ``data``); contracting
    against it in that layout would partial-sum the activations over the
    data axis.  Keeping only its TP dims sharded gathers the (small)
    weight instead, ZeRO-3's per-layer prefetch.  A ``redistribute`` of a
    DTensor; a no-op without a mesh or on a plain tensor."""
    if parallel is None or not getattr(parallel, "axis_sizes", None) \
            or not is_dtensor(w):
        return w
    m = parallel.size_of(parallel.model_axis)
    if m <= 1:
        return w
    spec = [None] * w.ndim
    for d in tp_dims:
        if w.shape[d] % m == 0:
            spec[d] = parallel.model_axis
    return w.redistribute(w.device_mesh, to_placements(tuple(spec),
                                                       w.device_mesh))


def dense_init(shape, *, generator: torch.Generator, device,
               in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal fan-in init in float32: ``std * N(0, 1)`` cut at
    +-2 standard deviations, ``std = 1 / sqrt(shape[in_axis])``.  On
    ``meta`` (an abstract model) only the shape is made."""
    fan_in = shape[in_axis] if shape else 1
    std = 1.0 / math.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.is_meta:
        return t
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std)


def zeros_init(shape, specs, *, device) -> tuple:
    """(float32 zeros, their logical spec)."""
    return torch.zeros(shape, dtype=torch.float32, device=device), specs


# ----------------------------------------------------------------- norms ---


def init_rmsnorm(d: int, spec_axis: str = "embed", *, device) -> tuple:
    """(float32 ones [d], its logical spec)."""
    return torch.ones(d, dtype=torch.float32, device=device), (spec_axis,)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * w`` in float32, cast back (gemma's
    weight multiplies directly, not ``1 + w``)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# ------------------------------------------------------------------ rope ---


def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """float32 [head_dim / 2]: ``theta ** (-i / half)``, computed on the
    CPU (so every device rotates by the same frequencies)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32), exps)


def rope_angles(positions: torch.Tensor, freqs: torch.Tensor):
    """(cos, sin) float32 [..., S, half] of ``positions`` [..., S]: the
    rotation every layer applies, computed once per forward."""
    angles = positions[..., None].float() * freqs.to(positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split rotation of x [..., S, D] in float32, cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embedding. x: [..., S, D] with D even; positions: [..., S]
    (broadcast against x's leading dims)."""
    return apply_rope(x, *rope_angles(positions,
                                      rope_freqs(x.shape[-1], theta)))


# ------------------------------------------------------------------- mlp ---


def init_mlp(cfg: ModelConfig, d_ff: int, *, stacked: tuple = (),
             generator, device) -> dict:
    """GLU (``w_in``, ``w_gate``, ``w_out``) or plain (``w_in``, ``w_out``)
    MLP weights, in the reference's key order; ``stacked``: leading dims
    (the experts of a MoE layer)."""
    d = cfg.d_model
    p = {"w_in": dense_init((*stacked, d, d_ff), generator=generator,
                            device=device)}
    if cfg.activation in ("silu_glu", "gelu_glu"):
        p["w_gate"] = dense_init((*stacked, d, d_ff), generator=generator,
                                 device=device)
    p["w_out"] = dense_init((*stacked, d_ff, d), generator=generator,
                            device=device)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))``, one rounding to x's dtype per
    operation: ``jax.nn.silu``'s operations, which XLA rounds one by one
    in bfloat16 (``F.silu`` rounds once, and moves bfloat16 MoE routes
    at near ties)."""
    return x * (1 / (1 + torch.exp(-x)))


def apply_mlp(p, cfg: ModelConfig, x: torch.Tensor,
              parallel=None) -> torch.Tensor:
    """The dense MLP.  On DTensors its products run one block a rank
    (``tp_matmul``): the input products column-parallel (x whole in the
    sequence and the features, the hidden activations split by their
    features alone), the output product row-parallel (a partial sum over
    the split features)."""
    h = tp_matmul(x, use_site_tp(p["w_in"].to(x.dtype), (-1,), parallel))
    if cfg.activation in ("silu_glu", "gelu_glu"):
        g = tp_matmul(x, use_site_tp(p["w_gate"].to(x.dtype), (-1,),
                                     parallel))
        h = (silu(g) if cfg.activation == "silu_glu"
             else F.gelu(g, approximate="tanh")) * h
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return tp_matmul(h, use_site_tp(p["w_out"].to(x.dtype), (-2,), parallel))


# ------------------------------------------------------------- embedding ---


def init_embedding(cfg: ModelConfig, *, generator, device) -> torch.Tensor:
    return dense_init((cfg.vocab_size, cfg.d_model), generator=generator,
                      device=device, in_axis=-1)


def embed(table: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig):
    """Rows of the table in the activation dtype (gathered, then cast:
    the same values as the reference's cast-then-gather; ``F.embedding``,
    whose gradient DTensor lays out on a sharded table), times
    ``sqrt(d_model)`` rounded to that dtype where ``embed_scale``."""
    dt = act_dtype(cfg)
    if is_dtensor(table):
        # the lookup reads whole rows: a vocab-sharded table (the
        # dry-run's) is gathered over the vocab first, as a use site
        # gathers a weight (the masked vocab-parallel lookup's gradient
        # does not sum with the tied unembedding's)
        from torch.distributed.tensor import Replicate, Shard
        table = table.redistribute(table.device_mesh, [
            Replicate() if isinstance(q, Shard) and q.dim == 0 else q
            for q in table.placements])
    x = F.embedding(tokens, table).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """float32 logits; the final soft-cap ``c * tanh(logits / c)``.  On
    DTensors the head is whole and each rank takes its own rows
    (``row_parallel_head``), so the logits are whole in the vocabulary."""
    w = table_or_head.to(x.dtype)
    logits = row_parallel_head(x, w.T if table_or_head.shape[0]
                               == cfg.vocab_size else w).float()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
