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
``use_site_tp`` on the expert weights and ``_constrain`` on the dispatch
tensors act where the tensors are DTensors (the dry-run) and
``parallel`` has ``axis_sizes``; elsewhere they are no-ops.

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

from repro_torch.distributed.sharding import (is_dtensor, to_placements,
                                              tp_matmul, unsplit_rows,
                                              wrap_local)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, dense_init, init_mlp, silu,
                                       use_site_tp)


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


def _expert_ffn(p, cfg: ModelConfig, xe: torch.Tensor,
                parallel=None) -> torch.Tensor:
    """xe: [G, E, C, D] -> [G, E, C, D] through stacked expert weights
    (constrained at their use to the expert dim alone: the contraction
    gathers the layer's expert weights instead of all-reducing [G, E, C,
    F] activations over the data axis).  DTensor weights sharded over the
    experts alone run one (group, expert) block a rank."""
    ws = {name: use_site_tp(p[name].to(xe.dtype), (0,), parallel)
          for name in ("w_in", "w_gate", "w_out") if name in p}
    if is_dtensor(xe) and all(_experts_only(w) for w in ws.values()):
        return _expert_blocks(cfg, xe, ws)
    return _expert_math(cfg, xe, ws)


def _experts_only(w) -> bool:
    """A DTensor weight whole but for its expert dim."""
    from torch.distributed.tensor import Replicate, Shard
    return all(isinstance(q, Replicate)
               or (isinstance(q, Shard) and q.dim == 0)
               for q in w.placements)


def _expert_math(cfg: ModelConfig, xe, ws: dict):
    h = torch.einsum("gecd,edf->gecf", xe, ws["w_in"])
    if cfg.activation in ("silu_glu", "gelu_glu"):
        g = torch.einsum("gecd,edf->gecf", xe, ws["w_gate"])
        g = (silu(g) if cfg.activation == "silu_glu"
             else F.gelu(g, approximate="tanh"))
        h = g * h
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, ws["w_out"])


def _expert_blocks(cfg: ModelConfig, xe, ws: dict):
    """The expert products one block a rank: each mesh dim that shards the
    weights' experts shards xe's experts too, xe keeps its group sharding
    elsewhere, and each rank runs its groups through its experts (the
    products are independent over both)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = xe.device_mesh
    by_expert = [any(isinstance(w.placements[i], Shard)
                     for w in ws.values()) for i in range(mesh.ndim)]
    placements = [Shard(1) if e else (q if isinstance(q, Shard)
                                      and q.dim == 0 else Replicate())
                  for e, q in zip(by_expert, xe.placements)]
    w_place = [Shard(0) if e else Replicate() for e in by_expert]
    # a rank's weight gradient sums over its own groups: partial where
    # the groups are split
    w_grad = [Partial() if isinstance(q, Shard) and q.dim == 0 else w
              for q, w in zip(placements, w_place)]
    out = _expert_math(
        cfg, xe.redistribute(mesh, placements).to_local(),
        {k: w.redistribute(mesh, w_place).to_local(grad_placements=w_grad)
         for k, w in ws.items()})
    return wrap_local(out, mesh, placements, tuple(xe.shape))


def _combine(comb, ye):
    """y[g, t] = sum over (e, c) of comb[g, t, e, c] ye[g, e, c].  On
    DTensors one block a rank: where ye's experts are split, comb's are
    split alike and the block's sums are partial; where groups or tokens
    are split, the blocks keep them."""
    if not (is_dtensor(comb) and is_dtensor(ye)):
        return torch.einsum("gtec,gecd->gtd", comb, ye)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ye.device_mesh

    def split(q, dim):
        return isinstance(q, Shard) and q.dim == dim
    plan = []
    for qc, qy in zip(comb.placements, ye.placements):
        if split(qy, 1):
            plan.append((Shard(2), Shard(1), Partial()))
        elif split(qy, 0) or split(qc, 0):
            plan.append((Shard(0), Shard(0), Shard(0)))
        elif split(qc, 1):
            plan.append((Shard(1), Replicate(), Shard(1)))
        else:
            plan.append((Replicate(), Replicate(), Replicate()))
    c_pl, y_pl, o_pl = (list(x) for x in zip(*plan))
    out = torch.einsum("gtec,gecd->gtd",
                       comb.redistribute(mesh, c_pl).to_local(),
                       ye.redistribute(mesh, y_pl).to_local())
    return wrap_local(out, mesh, o_pl,
                      (comb.shape[0], comb.shape[1], ye.shape[3]))


def _constrain(t, spec, parallel):
    """Pin a MoE intermediate's layout: a ``redistribute`` of a DTensor to
    ``spec`` (one mesh axis or None a dim), where every named axis
    divides its dim; a no-op without ``axis_sizes`` or on a plain
    tensor."""
    if parallel is None or not getattr(parallel, "axis_sizes", None) \
            or not is_dtensor(t):
        return t
    ok = all(s is None or (parallel.size_of(s) > 0
                           and t.shape[i] % parallel.size_of(s) == 0)
             for i, s in enumerate(spec))
    if not ok:
        return t
    return t.redistribute(t.device_mesh, to_placements(tuple(spec),
                                                       t.device_mesh))


def _pin(t):
    """A DTensor redistributed to its own layout (a plain tensor as it
    is): nothing moves forward, and the backward brings the gradient to
    this layout."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def _whole(t):
    """A DTensor made whole on every rank (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor, *, exact: bool = False,
              routes: Optional[list] = None, parallel=None):
    """x: [B, S, D] -> (y [B, S, D], float32 aux loss).  ``routes``: a
    list that receives this call's ``Routing``."""
    m = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    n_groups, t = groups(cfg, b * s, exact)
    if exact:
        # one group over every token (decode): its ranks and capacity
        # count over all of them, so the tokens are gathered first
        x = _whole(x)
    # each use pinned: its gradient reaches the sum of the three in the
    # layout the reshape gave (DTensor may shard it otherwise, by the
    # tokens of a group, which it cannot fold back into the batch)
    xt = x.reshape(n_groups, t, d)
    with record_function("moe.dispatch"):
        r = route(tp_matmul(_pin(xt), p["router"].to(dt)).float(), cfg,
                  exact=exact)
        # a dropped pair points at class `capacity`, whose column is cut
        slot = torch.where(r.keep, r.rank, r.capacity)
        pos_oh = F.one_hot(slot, r.capacity + 1)[..., :r.capacity].to(dt)
        sel = F.one_hot(r.expert, m.n_experts).to(dt) \
            * r.keep[..., None].to(dt)
        disp = torch.einsum("gtke,gtkc->gtec", sel, pos_oh)
        comb = torch.einsum("gtke,gtkc->gtec", sel * r.gate[..., None].to(dt),
                            pos_oh)
        da = parallel.data_axis if parallel else None
        ma = parallel.model_axis if parallel else None
        disp = _constrain(disp, (da, None, ma, None), parallel)
        comb = _constrain(comb, (da, None, ma, None), parallel)
        xe = torch.einsum("gtec,gtd->gecd", disp, _pin(xt))
        xe = _constrain(xe, (da, ma, None, None), parallel)
    with record_function("moe.experts"):
        ye = _expert_ffn(p["experts"], cfg, xe, parallel)
        ye = _constrain(ye, (da, ma, None, None), parallel)
        if exact:     # the experts' partial sums, reduced for the combine
            ye = _whole(ye)
    with record_function("moe.combine"):
        y = _combine(comb, ye)
    if m.n_shared_experts:
        y = y + apply_mlp(p["shared"], cfg, _pin(xt), parallel)
    # the Switch load-balance loss
    me = r.probs.mean(dim=(0, 1))
    ce = F.one_hot(r.expert[..., 0], m.n_experts).float().mean(dim=(0, 1))
    aux = m.n_experts * (me * ce).sum() * m.router_aux_weight
    if routes is not None:
        routes.append(r)
    return unsplit_rows(y, x, (b, s, d)), aux
