"""Decoder stack of dense ``global`` / ``local`` attention blocks.

Counterpart of ``repro.models.transformer`` for the dense GQA
architectures.  The reference stacks each pattern slot's weights over the
periods and runs one ``lax.scan`` per slot: **all periods of slot 0, then
all periods of slot 1, ...**, then the tail.  For gemma3-1b (pattern 5 x
local + global, 4 periods, a 2-layer tail) the executed order is 20 local
layers, 4 global, 2 local, not L,L,L,L,L,G repeated.  The port holds its
layers in that executed order (``Transformer.kinds``, ``layer_slots``),
so the same weights give the same function.

The module holds its weights (float32, as the reference's) and runs
forward only: the flash kernel has no backward, in the reference as here.
Caches mirror the reference's layout, ``{"blocks": [KVCache per slot with
k, v of [n_periods, B, Hkv, S, D]], "tail": [...]}``; layer (slot j,
period i) attends over ``cache["blocks"][j]`` at period i, written in
place.  MoE, MLA, SSM, RG-LRU blocks, prefix embeddings and cross-attention
memory raise ``NotImplementedError`` (``ROADMAP.md`` Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core.hashing import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, embed, init_embedding,
                                       init_mlp, rmsnorm, rope_angles,
                                       rope_freqs, unembed)

DENSE_KINDS = ("global", "local")


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor
    cache: Any = None


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in d.items()})


def layer_slots(cfg: ModelConfig) -> list[tuple[str, int, int]]:
    """The executed layer order as ``(group, slot, period)``: every period
    of pattern slot 0, then of slot 1, ..., then the tail slots
    (``group`` is ``"blocks"`` or ``"tail"``)."""
    out = [("blocks", j, i) for j in range(cfg.period)
           for i in range(cfg.n_periods)]
    out += [("tail", j, 0) for j in range(len(cfg.tail))]
    return out


class Block(nn.Module):
    """norm1 -> attention (-> norm1b) -> residual -> norm2 -> MLP
    (-> norm2b) -> residual; the ``b`` norms where ``use_post_norm``."""

    def __init__(self, cfg: ModelConfig, kind: str, *, generator, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        d = cfg.d_model
        norms = {"norm1": torch.ones(d, device=device)}
        self.mixer = _params(attn_mod.init_attention(
            cfg, generator=generator, device=device))
        if cfg.use_post_norm:
            norms["norm1b"] = torch.ones(d, device=device)
        norms["norm2"] = torch.ones(d, device=device)
        self.mlp = _params(init_mlp(cfg, cfg.d_ff, generator=generator,
                                    device=device))
        if cfg.use_post_norm:
            norms["norm2b"] = torch.ones(d, device=device)
        self.norms = _params(norms)

    def forward(self, x, *, rot, cache=None, cache_pos=None):
        cfg = self.cfg
        h = rmsnorm(x, self.norms["norm1"], cfg.rms_eps)
        window = cfg.window if self.kind == "local" else None
        out, cache = attn_mod.apply_attention(
            self.mixer, cfg, h, rot=rot, window=window, cache=cache,
            cache_pos=cache_pos)
        if cfg.use_post_norm:
            out = rmsnorm(out, self.norms["norm1b"], cfg.rms_eps)
        x = x + out
        h = rmsnorm(x, self.norms["norm2"], cfg.rms_eps)
        out = apply_mlp(self.mlp, cfg, h)
        if cfg.use_post_norm:
            out = rmsnorm(out, self.norms["norm2b"], cfg.rms_eps)
        return x + out, cache


def check_supported(cfg: ModelConfig) -> None:
    unported = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("ssm", cfg.ssm is not None or cfg.family == "ssm"),
        ("rglru", cfg.rglru is not None or "rglru" in cfg.pattern),
        ("prefix_embeds", cfg.prefix_embed_len > 0),
        ("memory", cfg.cross_attn_memory_len > 0)) if on]
    unported += sorted(set(cfg.pattern) - {*DENSE_KINDS, "rglru"})
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet (ROADMAP.md "
            f"Queue 1 item 12); the port runs dense global/local blocks")


class Transformer(nn.Module):
    """The decoder stack, its weights initialised from ``seed`` on
    ``device`` (fan-in truncated normal, norms at 1; other numbers than the
    reference's ``jax.random`` draws: ``convert.
    transformer_params_from_numpy`` loads the reference's weights).
    ``device="cuda"`` raises without a card."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device: str = "cuda"):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        emb = {"embed": init_embedding(cfg, generator=gen, device=dev)}
        if not cfg.tie_embeddings:
            emb["lm_head"] = init_embedding(cfg, generator=gen, device=dev)
        emb["final_norm"] = torch.ones(cfg.d_model, device=dev)
        self.emb = _params(emb)
        self.slots = layer_slots(cfg)
        self.kinds = [cfg.pattern[j] if g == "blocks" else cfg.tail[j]
                      for g, j, _i in self.slots]
        self.layers = nn.ModuleList(
            Block(cfg, kind, generator=gen, device=dev)
            for kind in self.kinds)
        self.register_buffer("rope_freqs",
                             rope_freqs(cfg.head_dim_, cfg.rope_theta).to(dev),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.emb["embed"].device

    # ------------------------------------------------------------ apply --

    @torch.no_grad()
    def apply(self, tokens, *, cache=None, cache_pos: Optional[int] = None,
              prefix_embeds=None, memory=None) -> ModelOutput:
        """tokens: int [B, S] -> ModelOutput (float32 logits [B, S, V]).

        Without ``cache`` this is the full-sequence forward (flash
        attention); with ``cache`` and ``cache_pos`` (a host int) it is
        prefill or decode, and the returned cache is the given one, written
        in place.
        """
        if prefix_embeds is not None or memory is not None:
            raise NotImplementedError(
                "prefix_embeds / memory: not ported yet (ROADMAP.md Queue 1 "
                "item 12)")
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed(self.emb["embed"], tokens, cfg)
        b, s, _ = x.shape
        start = 0 if cache_pos is None else int(cache_pos)
        positions = (start + torch.arange(s, device=x.device))[None, :] \
            .expand(b, s)
        # one rotation table for every layer (the reference recomputes it
        # per layer, with the same float32 operations)
        rot = rope_angles(positions[:, None, :], self.rope_freqs)
        for layer, (group, j, i) in zip(self.layers, self.slots):
            lc = None
            if cache is not None:
                slot = cache[group][j]
                lc = KVCache(slot.k[i], slot.v[i])
            x, _ = layer(x, rot=rot, cache=lc, cache_pos=cache_pos)
        x = rmsnorm(x, self.emb["final_norm"], cfg.rms_eps)
        head = (self.emb["lm_head"] if "lm_head" in self.emb
                else self.emb["embed"])
        logits = unembed(head, x, cfg)
        return ModelOutput(logits=logits, cache=cache)

    # ------------------------------------------------------------ cache --

    def _slot_cache(self, kind, n, batch, max_len, dtype, *, window_bound):
        cfg = self.cfg
        klen = max_len
        if window_bound and kind == "local":
            klen = min(max_len, cfg.window)
        shape = (n, batch, cfg.n_kv_heads, klen, cfg.head_dim_)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=self.device),
                       v=torch.zeros(shape, dtype=dtype, device=self.device))

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16, window_bound: bool = False) -> dict:
        """Per pattern slot, k and v stacked over periods.
        ``window_bound=True`` gives local slots a window-long ring."""
        cfg = self.cfg
        out = {"blocks": [
            self._slot_cache(kind, cfg.n_periods, batch, max_len, dtype,
                             window_bound=window_bound)
            for kind in cfg.pattern]}
        if cfg.tail:
            out["tail"] = [self._slot_cache(kind, 1, batch, max_len, dtype,
                                            window_bound=window_bound)
                           for kind in cfg.tail]
        return out

    def decode_step(self, cache, tokens, pos: int) -> ModelOutput:
        """tokens: [B, 1]; pos: host int — one decode step."""
        return self.apply(tokens, cache=cache, cache_pos=pos)
