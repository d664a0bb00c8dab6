"""Carry filter state across from the reference as numpy arrays.

Tables and stashes cross as ``uint32`` numpy arrays (the reference's
dtype) and live here as ``int32`` tensors with the same bit pattern.
``ocf_from_numpy`` also loads the keystore (and, optionally, the policy,
stats and capacity history), so a port ``OCF`` can continue a stream
from the reference's state.  ``adaptive_state_from_numpy`` does the same
for the four planes of the adaptive filter, and
``generational_from_numpy`` for the streaming generation ring, and
``sharded_state_from_numpy`` for the sharded filter's stacked tables and
stashes (``sharded_state_to_numpy`` gives them back).

The LM stack's weights cross as the reference's parameter pytree of
float32 numpy arrays (``embed``, ``final_norm``, ``prefix[...]`` stacked
over a MoE model's dense prefix, ``blocks[j][...]`` stacked over periods,
``tail[j][...]`` stacked over one; a MoE block's ``mlp`` holds
``router``, ``experts`` stacked over the experts and ``shared``, an MLA
block's ``mixer`` ``wq``, ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``,
``wo``; an ``ssm`` block holds ``norm1`` and its ``mixer`` only, an
``rglru`` block the RG-LRU's weights as its ``mixer``, a cross-attention
block ``xattn`` and ``norm_x`` besides): ``transformer_params_from_numpy``
loads them into the port's ``Transformer`` in its executed layer order,
``transformer_params_to_numpy`` gives them back in that pytree, and
``cache_to_numpy`` gives a cache (KV, MLA latent, SSM or RG-LRU) in the
reference's layout.  Any dict of tensors keyed by the model's parameter
names (gradients, AdamW's moments) crosses in the same pytree:
``named_to_numpy`` / ``named_from_numpy``, and for the optimizer
``adamw_state_to_numpy`` / ``adamw_state_from_numpy`` (``step``, and m
and v keyed as the parameter tree), so both packages can start from the
same parameters and optimizer state and be compared leaf by leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.adaptive.state import AdaptiveState
from repro_torch.core.distributed import (ShardedFilterState, place_shards,
                                          shard_layout)
from repro_torch.core.filter import FilterState
from repro_torch.core.hashing import resolve_device
from repro_torch.core.ocf import OCF, OcfConfig, OcfStats
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWState
from repro_torch.streaming.generations import (GenerationalFilter,
                                               GenerationConfig, GenStats,
                                               _Generation)
from repro_torch.streaming.stash import OverflowStash


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


def sharded_state_from_numpy(tables: np.ndarray,
                             stashes: Optional[np.ndarray] = None,
                             n_buckets: Optional[int] = None, *,
                             device="cuda", mesh=None, devices=None
                             ) -> ShardedFilterState:
    """uint32 tables [S, buf, b] (+ uint32 stashes [S, 2, slots])
    -> ``ShardedFilterState``, each shard on its device: laid out as
    ``mesh`` is, or one part a shard on ``devices``, or one part on
    ``device``."""
    cpu = torch.device("cpu")
    t = _tensor(tables, cpu)
    parts = (mesh.parts if mesh is not None else
             shard_layout(t.shape[0], device=device, devices=devices))
    return place_shards(parts, t,
                        None if stashes is None else _tensor(stashes, cpu),
                        None if n_buckets is None else int(n_buckets))


def sharded_state_to_numpy(state: ShardedFilterState) -> dict:
    """-> {"tables": uint32[S, buf, b], "stashes": uint32[S, 2, slots] or
    None, "n_buckets": int or None}, stacked over every part."""
    def u32(t):
        return t.detach().numpy().view(np.uint32).copy()
    tables, stashes = state.stacked("cpu")
    return {"tables": u32(tables),
            "stashes": None if stashes is None else u32(stashes),
            "n_buckets": state.n_buckets}


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


def generational_from_numpy(config: GenerationConfig, *, gens: list,
                            last_now: Optional[float],
                            stats: Optional[dict] = None
                            ) -> GenerationalFilter:
    """A ``GenerationalFilter`` holding the given ring state.

    ``gens`` lists the generations oldest first, each a dict with
    ``table`` (uint32 [buffer, bucket_size]), ``stash`` (uint32 [2, S]),
    ``count``, ``born`` and ``expires``; ``last_now`` is the ring's
    remembered clock and ``stats`` a ``GenStats`` field dict.  Each table
    and stash go into one of the ring's pool slots.
    """
    if not 1 <= len(gens) <= config.generations:
        raise ValueError(f"need 1..{config.generations} generations, got "
                         f"{len(gens)}")
    ring = GenerationalFilter(config, now=last_now)
    for g in ring.gens:
        ring.pool.release(g.slot)
    ring.gens = []
    for g in gens:
        slot = ring.pool.acquire()
        table, stash = ring.pool.tables[slot], ring.pool.stashes[slot]
        for name, dst in (("table", table), ("stash", stash)):
            src = np.asarray(g[name])
            if src.shape != tuple(dst.shape):
                raise ValueError(f"{name} shape {src.shape} is not the "
                                 f"pool's {tuple(dst.shape)}")
            dst.copy_(_tensor(src, ring.device))
        state = FilterState(
            table, torch.tensor(int(g["count"]), dtype=torch.int64,
                                device=ring.device), config.n_buckets)
        ring.gens.append(_Generation(state,
                                     OverflowStash(config.stash_slots,
                                                   array=stash),
                                     born=g["born"], expires=g["expires"],
                                     slot=slot))
    ring._last_now = last_now
    if stats is not None:
        ring.stats = GenStats(**stats)
    return ring


def generational_to_numpy(ring: GenerationalFilter) -> dict:
    """-> {"gens": [{"table", "stash": uint32 arrays, "count": int,
    "born", "expires"}, ...] oldest first, "last_now", "stats": dict}."""
    def u32(t):
        return t.detach().cpu().numpy().view(np.uint32).copy()
    return {"gens": [{"table": u32(g.state.table), "stash": u32(g.stash.array),
                      "count": int(g.state.count), "born": g.born,
                      "expires": g.expires} for g in ring.gens],
            "last_now": ring._last_now,
            "stats": dataclasses.asdict(ring.stats)}


# ------------------------------------------------------------- LM stack --

_BLOCK_GROUPS = ("mixer", "mlp", "xattn", "norms")


def _block_leaves(layer):
    """(reference key path, parameter) of one port block; the norms sit at
    the top of the reference's block dict.  An ``ssm`` block has no
    ``mlp`` (nor ``norm2``), a block without cross-attention no
    ``xattn``."""
    for group in _BLOCK_GROUPS:
        if group not in layer._modules:
            continue
        for name, param in getattr(layer, group).named_parameters():
            path = tuple(name.split("."))
            yield (path if group == "norms" else (group, *path)), param


def transformer_params_from_numpy(params_np: dict, cfg: ModelConfig, *,
                                  device="cuda") -> Transformer:
    """The reference's parameter pytree (numpy) -> a port ``Transformer``
    holding those weights: layer (slot j, period i) takes
    ``blocks[j][...][i]``, tail layer j takes ``tail[j][...][0]``."""
    model = Transformer(cfg, device=device)
    arrays = named_from_numpy(model, params_np)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(torch.from_numpy(np.array(arrays[name])).to(
                model.device))
    return model


def _named_leaves(model: Transformer) -> list:
    """(parameter name, reference key path, period index or None) of every
    parameter of ``model``; the path's second key is the slot index for
    ``blocks`` and ``tail``."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = [(names[id(p)], (name,), None)
           for name, p in model.emb.named_parameters()]
    for layer, (group, j, i) in zip(model.layers, model.slots):
        head = (group,) if group == "prefix" else (group, j)
        out += [(names[id(param)], head + path, i)
                for path, param in _block_leaves(layer)]
    return out


def named_to_numpy(model: Transformer, tensors: dict) -> dict:
    """``{parameter name: tensor}`` of ``model`` (its parameters, their
    gradients, AdamW's moments) -> the reference's parameter pytree of
    numpy arrays, blocks stacked over periods in the reference's order."""
    out, stacks = {}, {}
    for name, path, _i in _named_leaves(model):
        arr = tensors[name].detach().cpu().numpy()
        if len(path) == 1:
            out[path[0]] = arr
            continue
        group, rest = path[0], path[1:]
        j, rest = (0, rest) if group == "prefix" else (rest[0], rest[1:])
        node = stacks.setdefault(group, {}).setdefault(j, {})
        for key in rest[:-1]:
            node = node.setdefault(key, {})
        node.setdefault(rest[-1], []).append(arr)

    def stack(node):
        if isinstance(node, list):
            return np.stack(node)
        return {k: stack(v) for k, v in node.items()}

    for group, slots in stacks.items():
        out[group] = (stack(slots[0]) if group == "prefix" else
                      tuple(stack(slots[j]) for j in sorted(slots)))
    return out


def named_from_numpy(model: Transformer, tree: dict) -> dict:
    """The reference's parameter pytree -> ``{parameter name: numpy
    array}`` of ``model`` (layer (slot j, period i) takes ``[i]`` of its
    stacked leaf)."""
    out = {}
    for name, path, i in _named_leaves(model):
        arr = tree
        for key in path:
            arr = arr[key]
        out[name] = np.asarray(arr if i is None else arr[i])
    return out


def transformer_params_to_numpy(model: Transformer) -> dict:
    """A port ``Transformer``'s weights -> the reference's pytree (float32
    numpy), blocks stacked over periods in the reference's order."""
    return named_to_numpy(model, dict(model.named_parameters()))


def adamw_state_to_numpy(model: Transformer, state: AdamWState) -> dict:
    """-> {"step": int32 numpy scalar, "m": pytree, "v": pytree}, the
    moments in the reference's parameter tree."""
    return {"step": state.step.detach().cpu().numpy(),
            "m": named_to_numpy(model, state.m),
            "v": named_to_numpy(model, state.v)}


def adamw_state_from_numpy(model: Transformer, step, m: dict, v: dict
                           ) -> AdamWState:
    """The reference's AdamW state (step, m and v pytrees) -> the port's,
    on the model's device, keyed by its parameter names."""
    dev = model.device

    def tensors(tree):
        return {k: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
                for k, a in named_from_numpy(model, tree).items()}
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32, device=dev),
                      m=tensors(m), v=tensors(v))


def cache_to_numpy(cache: dict) -> dict:
    """A port cache -> ``{"blocks": [fields], "tail": [fields], "prefix":
    fields}`` of float32 numpy arrays in the reference's layout and field
    order, a tuple per slot: (k, v) of [n, B, Hkv, S, D] (MLA: k of [n, B,
    1, S, kv_lora + rope]); ``ssm`` (conv [n, B, d_conv - 1, conv_dim],
    state [n, B, H, P, N]); ``rglru`` (conv [n, B, d_conv - 1, d_rnn], h
    [n, B, d_rnn])."""
    def fields(c):
        return tuple(t.detach().float().cpu().numpy() for t in c)
    return {group: fields(slots) if group == "prefix" else
            [fields(c) for c in slots] for group, slots in cache.items()}
