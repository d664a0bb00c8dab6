"""Decoder stack: ``global`` / ``local`` attention blocks (dense or MoE
MLPs, MLA), Mamba-2 ``ssm`` blocks, Griffin ``rglru`` blocks,
cross-attention over a conditioning memory and prefix embeddings.

Counterpart of ``repro.models.transformer``.  The reference stacks each
pattern slot's weights over the periods and runs one ``lax.scan`` per
slot: the dense prefix (``first_k_dense`` layers of a MoE model) first,
then **all periods of slot 0, then all periods of slot 1, ...**, then the
tail.  For gemma3-1b (pattern 5 x local + global, 4 periods, a 2-layer
tail) the executed order is 20 local layers, 4 global, 2 local, not
L,L,L,L,L,G repeated; for recurrentgemma-2b (rglru, rglru, local; 8
periods, a 2-layer rglru tail) 8 rglru, 8 rglru, 8 local, 2 rglru.  The
port holds its layers in that executed order (``Transformer.kinds``,
``layer_slots``), so the same weights give the same function.

The module holds its weights (float32, as the reference's).  ``apply``
is the serving entry, under ``no_grad``; ``forward`` (``model(tokens)``)
is the training entry: the same cache-less function, differentiable
(flash attention's gradient is its ``FlashAttentionFn``), with the
reference's ``remat`` modes through ``torch.utils.checkpoint``.  The
weights are frozen parameters until a trainer makes them trainable
(``make_train_step`` calls ``requires_grad_()``).
Caches mirror the reference's layout, one cache per pattern slot stacked
over the periods, ``{"blocks": [...], "tail": [...], "prefix": ...}``:
``KVCache`` k, v of [n_periods, B, Hkv, S, D] (MLA: k of [n, B, 1, S,
kv_lora + rope], v unused), ``ssm.SsmCache`` (conv window, state) and
``rglru.RglruCache`` (conv window, h) of [n_periods, B, ...]; layer (slot
j, period i) reads and writes period i of ``cache["blocks"][j]`` in place.
A MoE block routes a decode step (a cache and one token) exactly, as the
reference does; ``ModelOutput.aux_loss`` sums the blocks' load-balance
losses.  ``prefix_embeds`` [B, P, E] go before the token embeddings
(positions run over both; logits cover the tokens only); ``memory`` [B,
M, memory_dim] feeds the cross-attention of the attention blocks of a
config with ``cross_attn_memory_len``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.hashing import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.distributed.sharding import constrain_batch_activations
from repro_torch.models.layers import (apply_mlp, embed, init_embedding,
                                       init_mlp, init_rmsnorm, rmsnorm,
                                       rope_angles, rope_freqs, unembed)

DENSE_KINDS = ("global", "local")
KINDS = (*DENSE_KINDS, "rglru", "ssm")
REMAT = ("none", "full", "dots")
# The matrix products "dots" keeps: products without batch dimensions
# (x @ w lowers to aten.mm), as the reference's
# dots_with_no_batch_dims_saveable keeps dot_generals without batch dims;
# batched products (MoE's einsums) and everything else are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(_ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor
    aux_loss: torch.Tensor        # float32 scalar; 0 without MoE blocks
    cache: Any = None


class ParamTree(nn.Module):
    """A nested dict of frozen parameters, read as ``p["a"]["b"]``;
    ``named_parameters()`` gives each leaf's dotted path."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def layer_slots(cfg: ModelConfig) -> list[tuple[str, int, int]]:
    """The executed layer order as ``(group, slot, period)``: the dense
    prefix, then every period of pattern slot 0, then of slot 1, ..., then
    the tail slots (``group`` is ``"prefix"``, ``"blocks"`` or
    ``"tail"``)."""
    prefix = cfg.moe.first_k_dense if cfg.moe else 0
    out = [("prefix", 0, i) for i in range(prefix)]
    out += [("blocks", j, i) for j in range(cfg.period)
            for i in range(cfg.n_periods)]
    out += [("tail", j, 0) for j in range(len(cfg.tail))]
    return out


class Block(nn.Module):
    """One layer of kind ``global`` / ``local`` / ``rglru``: norm1 ->
    attention, MLA or RG-LRU (-> norm1b) -> residual (-> norm_x ->
    cross-attention -> residual, where the block has ``xattn`` and a
    memory is given) -> norm2 -> MLP or MoE (-> norm2b) -> residual; the
    ``b`` norms where ``use_post_norm``.  A MoE model's prefix blocks and
    its ``rglru`` blocks take a dense MLP of ``d_ff``.  Kind ``ssm`` (a
    Mamba-2 block) holds norm1 and the mixer only: x + mixer(norm1(x))."""

    def __init__(self, cfg: ModelConfig, kind: str, *, generator, device,
                 in_prefix: bool = False):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        d = cfg.d_model

        def ones():
            return init_rmsnorm(d, device=device)[0]
        norms = {"norm1": ones()}
        init = dict(generator=generator, device=device)
        if kind == "ssm":
            self.moe = False
            self.mixer = ParamTree(ssm_mod.init_ssm(cfg, **init))
            self.norms = ParamTree(norms)
            return
        self.moe = cfg.moe is not None and not in_prefix and kind != "rglru"
        init_mixer = (rglru_mod.init_rglru if kind == "rglru"
                      else attn_mod.init_mla if cfg.mla is not None
                      else attn_mod.init_attention)
        self.mixer = ParamTree(init_mixer(cfg, **init))
        if cfg.use_post_norm:
            norms["norm1b"] = ones()
        norms["norm2"] = ones()
        self.mlp = ParamTree(moe_mod.init_moe(cfg, **init) if self.moe
                             else init_mlp(cfg, cfg.d_ff, **init))
        if cfg.use_post_norm:
            norms["norm2b"] = ones()
        if cfg.cross_attn_memory_len and kind in DENSE_KINDS:
            self.xattn = ParamTree(attn_mod.init_cross_attention(cfg,
                                                                 **init))
            norms["norm_x"] = ones()
        self.norms = ParamTree(norms)

    def forward(self, x, *, rot, cache=None, cache_pos=None, routes=None,
                memory=None, parallel=None):
        """-> (x, cache, float32 aux loss or None).  ``routes``: a list
        that receives a MoE block's ``moe.Routing``; ``memory``: the
        cross-attention memory (ignored by a block without ``xattn``);
        ``parallel``: the use-site constraints' ``ParallelConfig`` (off at
        decode, as in the reference: there the activation all-reduce is
        cheaper than gathering the weights every step)."""
        cfg = self.cfg
        if cache is not None and x.shape[1] == 1 and parallel is not None:
            parallel = dataclasses.replace(parallel, axis_sizes=None)
        h = rmsnorm(x, self.norms["norm1"], cfg.rms_eps)
        if self.kind == "ssm":
            out, cache = ssm_mod.apply_ssm(self.mixer, cfg, h, cache=cache,
                                           parallel=parallel)
            return x + out, cache, None
        if self.kind == "rglru":
            out, cache = rglru_mod.apply_rglru(self.mixer, cfg, h,
                                               cache=cache,
                                               parallel=parallel)
        elif cfg.mla is not None:
            out, cache = attn_mod.apply_mla(self.mixer, cfg, h, rot=rot,
                                            cache=cache, cache_pos=cache_pos,
                                            parallel=parallel)
        else:
            window = cfg.window if self.kind == "local" else None
            out, cache = attn_mod.apply_attention(
                self.mixer, cfg, h, rot=rot, window=window, cache=cache,
                cache_pos=cache_pos, parallel=parallel)
        if cfg.use_post_norm:
            out = rmsnorm(out, self.norms["norm1b"], cfg.rms_eps)
        # the residual rounds to x's dtype, the norm reads the float32 sum:
        # XLA fuses the add into the norm's float32 cast (in bfloat16 a
        # rounded norm input moves MoE routes at near ties)
        s = x.float() + out.float()
        x = s.to(x.dtype)
        if memory is not None and "xattn" in self._modules:
            hx = rmsnorm(s, self.norms["norm_x"], cfg.rms_eps).to(x.dtype)
            s = x.float() + attn_mod.apply_cross_attention(
                self.xattn, cfg, hx, memory).float()
            x = s.to(x.dtype)
        h = rmsnorm(s, self.norms["norm2"], cfg.rms_eps).to(x.dtype)
        aux = None
        if self.moe:
            exact = cache is not None and x.shape[1] == 1   # decode
            out, aux = moe_mod.apply_moe(self.mlp, cfg, h, exact=exact,
                                         routes=routes, parallel=parallel)
        else:
            out = apply_mlp(self.mlp, cfg, h, parallel)
        if cfg.use_post_norm:
            out = rmsnorm(out, self.norms["norm2b"], cfg.rms_eps)
        return x + out, cache, aux


def check_supported(cfg: ModelConfig) -> None:
    """ValueError for a block kind the reference does not know, or an
    ``ssm`` / ``rglru`` kind without its sub-config."""
    unknown = sorted(set(cfg.pattern) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}; the "
                         f"stack runs {', '.join(KINDS)}")
    for kind, sub in (("ssm", cfg.ssm), ("rglru", cfg.rglru)):
        if kind in cfg.pattern and sub is None:
            raise ValueError(f"{cfg.name}: {kind} blocks need cfg.{kind}")


class Transformer(nn.Module):
    """The decoder stack, its weights initialised from ``seed`` on
    ``device`` (fan-in truncated normal, norms at 1; other numbers than the
    reference's ``jax.random`` draws: ``convert.
    transformer_params_from_numpy`` loads the reference's weights).
    ``device="cuda"`` raises without a card; ``device="meta"`` builds the
    abstract model (shapes only, no draws) the dry-run lays out."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device: str = "cuda"):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device, construct=True)
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        emb = {"embed": init_embedding(cfg, generator=gen, device=dev)}
        if not cfg.tie_embeddings:
            emb["lm_head"] = init_embedding(cfg, generator=gen, device=dev)
        emb["final_norm"] = init_rmsnorm(cfg.d_model, device=dev)[0]
        self.emb = ParamTree(emb)
        self.slots = layer_slots(cfg)
        self.kinds = [cfg.tail[j] if g == "tail" else cfg.pattern[j]
                      for g, j, _i in self.slots]
        self.layers = nn.ModuleList(
            Block(cfg, kind, generator=gen, device=dev,
                  in_prefix=group == "prefix")
            for kind, (group, _j, _i) in zip(self.kinds, self.slots))
        # MLA rotates only its qk_rope_dim dims, at that width's frequencies
        rope_dim = cfg.mla.qk_rope_dim if cfg.mla else cfg.head_dim_
        self.register_buffer("rope_freqs",
                             rope_freqs(rope_dim, cfg.rope_theta).to(dev),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.emb["embed"].device

    def rotation(self, batch: int, length: int, start: int = 0):
        """The (cos, sin) that every layer of a call over positions
        ``start ..`` applies (the reference recomputes it per layer, with
        the same float32 operations)."""
        positions = start + torch.arange(length, device=self.device)
        return rope_angles(positions[None, None, :].expand(batch, 1, length),
                           self.rope_freqs)

    # ------------------------------------------------------------ apply --

    @torch.no_grad()
    def apply(self, tokens, *, cache=None, cache_pos: Optional[int] = None,
              prefix_embeds=None, memory=None,
              routes: Optional[list] = None, parallel=None) -> ModelOutput:
        """tokens: int [B, S] -> ModelOutput (float32 logits [B, S, V],
        the float32 aux loss summed over the MoE blocks).

        Without ``cache`` this is the full-sequence forward (flash
        attention); with ``cache`` and ``cache_pos`` (a host int) it is
        prefill or decode, and the returned cache is the given one, written
        in place.  ``prefix_embeds`` [B, P, E] go before the token
        embeddings (the positions run over both from ``cache_pos``; the
        logits cover the S token positions only); ``memory`` [B, M,
        memory_dim] feeds the cross-attention blocks.  ``routes``: a list
        that receives each MoE block's ``moe.Routing``, in the executed
        order.  ``parallel``: a ``ParallelConfig`` with ``axis_sizes``
        turns on the reference's sharding constraints (block-boundary
        activations, use-site weights) where the tensors are DTensors.
        """
        return self._run(tokens, cache=cache, cache_pos=cache_pos,
                         prefix_embeds=prefix_embeds, memory=memory,
                         routes=routes, parallel=parallel)

    def forward(self, tokens, *, prefix_embeds=None, memory=None,
                remat: str = "none", parallel=None) -> ModelOutput:
        """The differentiable cache-less forward (training): ``apply``'s
        function without a cache, under the caller's grad mode.  ``remat``
        as the reference's: ``"none"`` keeps every activation the backward
        needs, ``"full"`` keeps only each layer's input and runs its
        forward again in the backward, ``"dots"`` keeps the layer's matrix
        products without batch dimensions as well and recomputes the rest.
        Remat changes memory, never numbers."""
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        return self._run(tokens, prefix_embeds=prefix_embeds, memory=memory,
                         remat=remat, parallel=parallel)

    def _run(self, tokens, *, cache=None, cache_pos=None, prefix_embeds=None,
             memory=None, routes=None, remat: str = "none",
             parallel=None) -> ModelOutput:
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed(self.emb["embed"], tokens, cfg)
        n_prefix = 0
        if prefix_embeds is not None:
            prefix_embeds = torch.as_tensor(prefix_embeds, device=self.device)
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
            n_prefix = prefix_embeds.shape[1]
        if memory is not None:
            memory = torch.as_tensor(memory, device=self.device)
        b, s, _ = x.shape
        rot = self.rotation(b, s, 0 if cache_pos is None else int(cache_pos))
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, (group, j, i) in zip(self.layers, self.slots):
            lc = None
            if cache is not None:
                slot = cache[group] if group == "prefix" else cache[group][j]
                lc = type(slot)(*(t[i] for t in slot))
            x = constrain_batch_activations(x, parallel)
            if remat == "none":
                x, _, aux = layer(x, rot=rot, cache=lc, cache_pos=cache_pos,
                                  routes=routes, memory=memory,
                                  parallel=parallel)
            else:
                ctx = (_dots_context if remat == "dots"
                       else ckpt.noop_context_fn)
                x, _, aux = ckpt.checkpoint(
                    functools.partial(layer, rot=rot, memory=memory,
                                      parallel=parallel), x,
                    use_reentrant=False, context_fn=ctx)
            if aux is not None:
                aux_total = aux_total + aux
        x = rmsnorm(x[:, n_prefix:], self.emb["final_norm"], cfg.rms_eps)
        head = (self.emb["lm_head"] if "lm_head" in self.emb
                else self.emb["embed"])
        logits = unembed(head, x, cfg)
        return ModelOutput(logits=logits, aux_loss=aux_total, cache=cache)

    # ------------------------------------------------------------ cache --

    def _slot_cache(self, kind, n, batch, max_len, dtype, *, window_bound,
                    device):
        cfg = self.cfg
        if kind == "ssm":
            return ssm_mod.init_ssm_cache(cfg, batch, dtype, stacked=(n,),
                                          device=device)
        if kind == "rglru":
            return rglru_mod.init_rglru_cache(cfg, batch, dtype,
                                              stacked=(n,),
                                              device=device)
        if cfg.mla is not None:
            m = cfg.mla
            width = m.kv_lora_rank + m.qk_rope_dim
            return KVCache(
                k=torch.zeros((n, batch, 1, max_len, width), dtype=dtype,
                              device=device),
                v=torch.zeros((n, 1, 1, 1, 1), dtype=dtype,
                              device=device))
        klen = max_len
        if window_bound and kind == "local":
            klen = min(max_len, cfg.window)
        shape = (n, batch, cfg.n_kv_heads, klen, cfg.head_dim_)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16, window_bound: bool = False,
                   device=None) -> dict:
        """Per pattern slot, its cache stacked over periods (and the dense
        prefix's, stacked over its layers): k and v of ``max_len`` for
        attention slots, the constant-size conv window and state for
        ``ssm`` and ``rglru`` slots.  ``window_bound=True`` gives local
        slots a window-long ring.  ``device``: the model's by default;
        ``"meta"`` gives the abstract cache (shapes only)."""
        cfg = self.cfg
        device = (self.device if device is None
                  else resolve_device(device, construct=True))
        out = {"blocks": [
            self._slot_cache(kind, cfg.n_periods, batch, max_len, dtype,
                             window_bound=window_bound, device=device)
            for kind in cfg.pattern]}
        if cfg.tail:
            out["tail"] = [self._slot_cache(kind, 1, batch, max_len, dtype,
                                            window_bound=window_bound,
                                            device=device)
                           for kind in cfg.tail]
        prefix = cfg.moe.first_k_dense if cfg.moe else 0
        if prefix:
            out["prefix"] = self._slot_cache(cfg.pattern[0], prefix, batch,
                                             max_len, dtype,
                                             window_bound=window_bound,
                                             device=device)
        return out

    def decode_step(self, cache, tokens, pos: int, *,
                    memory=None) -> ModelOutput:
        """tokens: [B, 1]; pos: host int — one decode step."""
        return self.apply(tokens, memory=memory, cache=cache, cache_pos=pos)
