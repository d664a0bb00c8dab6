"""Mixture-of-Experts with group-limited, capacity-based routing.

Counterpart of ``repro.models.moe``.  Tokens are routed in groups of
``group_size`` (one group when ``exact`` or when the call has at most
``group_size`` tokens; otherwise the token count must divide by it).  In
each group every token picks its ``top_k`` experts by router probability;
an expert takes at most ``capacity = max(1, int(T * top_k *
capacity_factor / E))`` of the group's (token, choice) pairs, in the
order of the group's tokens and then of each token's choices, and drops
the rest.  ``exact=True`` (decode) is one group of capacity T: nothing
drops.  Dispatch and combine are one-hot einsums over [G, T, E, C], the
expert products einsums over the stacked expert weights [E, ...], as in
the reference (which computes them outside any Pallas kernel).

Routing matches the reference's bit for bit given the same router logits
(``route``): ties between gates go to the lower expert index (a stable
descending sort; ``jax.lax.top_k``'s order), a dropped pair's one-hot row
is all zero (``jax.nn.one_hot`` of the out-of-range index ``capacity``),
and in bfloat16 the one-hots, ``sel * gate`` and the einsums take the
activation dtype where the reference's do.  ``apply_moe`` returns the
Switch load-balance loss beside the output.  The reference's
``use_site_tp`` and ``_constrain`` (sharding constraints) have no mesh to
act on here and are dropped.

The router, the routing and the dispatch einsums, the expert products
and the combine run inside the profiler ranges ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` (a trace reads their device time;
without a profiler a range costs a flag test).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, silu


class Routing(NamedTuple):
    """One call's routing, per group g, token t and choice k."""
    probs: torch.Tensor     # float32 [G, T, E] router probabilities
    gate: torch.Tensor      # float32 [G, T, k] gates (renormalised)
    expert: torch.Tensor    # int64 [G, T, k] expert indices
    rank: torch.Tensor      # int64 [G, T, k] rank at that expert in-group
    keep: torch.Tensor      # bool [G, T, k] rank < capacity
    capacity: int


def init_moe(cfg: ModelConfig, *, generator, device) -> dict:
    """``router`` [d, E], ``experts`` (MLP weights stacked over E) and,
    with shared experts, ``shared`` (one MLP of their summed width), in
    the reference's shapes."""
    m = cfg.moe
    p = {"router": dense_init((cfg.d_model, m.n_experts),
                              generator=generator, device=device)}
    p["experts"] = init_mlp(cfg, m.expert_d_ff, stacked=(m.n_experts,),
                            generator=generator, device=device)
    if m.n_shared_experts:
        p["shared"] = init_mlp(
            cfg, (m.shared_d_ff or m.expert_d_ff) * m.n_shared_experts,
            generator=generator, device=device)
    return p


def groups(cfg: ModelConfig, n_tok: int, exact: bool) -> tuple[int, int]:
    """(G, T): the routing groups of a call of ``n_tok`` tokens."""
    gs = cfg.moe.group_size
    if exact or n_tok <= gs:
        return 1, n_tok
    if n_tok % gs:
        raise ValueError(f"{n_tok} tokens not divisible by group {gs}")
    return n_tok // gs, gs


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, cfg: ModelConfig, *,
          exact: bool = False) -> Routing:
    """float32 router logits [G, T, E] -> the group's ``Routing``."""
    m = cfg.moe
    g, t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, m.top_k)
    if m.norm_topk:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    capacity = t if exact else max(1, int(t * m.top_k * m.capacity_factor
                                          / m.n_experts))
    # rank of each (token, choice) at its expert: the count of earlier
    # pairs of the group, in token-then-choice order, at the same expert
    onehot = F.one_hot(expert, e).reshape(g, t * m.top_k, e)
    rank = torch.cumsum(onehot, dim=1).reshape(g, t, m.top_k, e)
    rank = torch.gather(rank, 3, expert[..., None])[..., 0] - 1
    keep = rank < capacity
    return Routing(probs, gate, expert, rank, keep, capacity)


def _expert_ffn(p, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """xe: [G, E, C, D] -> [G, E, C, D] through stacked expert weights."""
    h = torch.einsum("gecd,edf->gecf", xe, p["w_in"].to(xe.dtype))
    if cfg.activation in ("silu_glu", "gelu_glu"):
        g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(xe.dtype))
        g = (silu(g) if cfg.activation == "silu_glu"
             else F.gelu(g, approximate="tanh"))
        h = g * h
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, p["w_out"].to(xe.dtype))


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor, *, exact: bool = False,
              routes: Optional[list] = None):
    """x: [B, S, D] -> (y [B, S, D], float32 aux loss).  ``routes``: a
    list that receives this call's ``Routing``."""
    m = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    n_groups, t = groups(cfg, b * s, exact)
    xt = x.reshape(n_groups, t, d)
    with record_function("moe.dispatch"):
        r = route((xt @ p["router"].to(dt)).float(), cfg, exact=exact)
        # a dropped pair points at class `capacity`, whose column is cut
        slot = torch.where(r.keep, r.rank, r.capacity)
        pos_oh = F.one_hot(slot, r.capacity + 1)[..., :r.capacity].to(dt)
        sel = F.one_hot(r.expert, m.n_experts).to(dt) \
            * r.keep[..., None].to(dt)
        disp = torch.einsum("gtke,gtkc->gtec", sel, pos_oh)
        comb = torch.einsum("gtke,gtkc->gtec", sel * r.gate[..., None].to(dt),
                            pos_oh)
        xe = torch.einsum("gtec,gtd->gecd", disp, xt)
    with record_function("moe.experts"):
        ye = _expert_ffn(p["experts"], cfg, xe)
    with record_function("moe.combine"):
        y = torch.einsum("gtec,gecd->gtd", comb, ye)
    if m.n_shared_experts:
        y = y + apply_mlp(p["shared"], cfg, xt)
    # the Switch load-balance loss
    me = r.probs.mean(dim=(0, 1))
    ce = F.one_hot(r.expert[..., 0], m.n_experts).float().mean(dim=(0, 1))
    aux = m.n_experts * (me * ce).sum() * m.router_aux_weight
    if routes is not None:
        routes.append(r)
    return y.reshape(b, s, d), aux
