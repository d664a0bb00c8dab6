"""Abstract inputs and state for the dry-run: shapes and logical specs,
nothing allocated.

Counterpart of ``repro.launch.specs`` (``abstract_init``,
``abstract_cache``, ``batch_specs``).  A ``meta`` tensor stands where the
reference has a ``ShapeDtypeStruct``: ``abstract_init`` builds the model
on ``meta`` (no draws, no storage) and gives each named parameter its
logical axis names, ``abstract_cache`` the cache of a step, and
``batch_specs`` the inputs the shape's mode selects:

  train_*   -> train_step(params, opt_state, batch)
  prefill_* -> prefill(cache, tokens)
  decode_*  -> decode(cache, token[B, 1], pos)

The logical specs are one table, ``LOGICAL_SPECS``, keyed by a leaf's key
path in the reference's parameter tree (``convert``'s name map carries a
port name to that path), each the reference's spec with the stacked
``layers`` axis dropped (the port holds one module a layer).  The two
keys whose spec depends on the mixer (the depthwise conv of a Mamba-2
and of an RG-LRU block) take the block kind as well.
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import SHAPES
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

# key path below a block (or a top-level key) -> logical spec
LOGICAL_SPECS = {
    ("embed",): ("vocab", "embed"),
    ("lm_head",): ("vocab", "embed"),
    ("final_norm",): ("embed",),
    ("norm1",): ("embed",), ("norm1b",): ("embed",),
    ("norm2",): ("embed",), ("norm2b",): ("embed",),
    ("norm_x",): ("embed",),
    # attention and MLA
    ("mixer", "wq"): ("embed", "heads"),
    ("mixer", "wk"): ("embed", "kv"),
    ("mixer", "wv"): ("embed", "kv"),
    ("mixer", "wo"): ("heads", "embed"),
    ("mixer", "q_norm"): (None,), ("mixer", "k_norm"): (None,),
    ("mixer", "w_dkv"): ("embed", "lora"),
    ("mixer", "kv_norm"): ("lora",),
    ("mixer", "w_uk"): ("lora", "heads"),
    ("mixer", "w_uv"): ("lora", "heads"),
    # cross-attention
    ("xattn", "wq"): ("embed", "heads"),
    ("xattn", "wk"): ("mem", "kv"),
    ("xattn", "wv"): ("mem", "kv"),
    ("xattn", "wo"): ("heads", "embed"),
    # MLPs, MoE
    ("mlp", "w_in"): ("embed", "mlp"), ("mlp", "w_gate"): ("embed", "mlp"),
    ("mlp", "w_out"): ("mlp", "embed"),
    ("mlp", "router"): ("embed", None),
    ("mlp", "experts", "w_in"): ("expert", "embed", "mlp"),
    ("mlp", "experts", "w_gate"): ("expert", "embed", "mlp"),
    ("mlp", "experts", "w_out"): ("expert", "mlp", "embed"),
    ("mlp", "shared", "w_in"): ("embed", "mlp"),
    ("mlp", "shared", "w_gate"): ("embed", "mlp"),
    ("mlp", "shared", "w_out"): ("mlp", "embed"),
    # Mamba-2
    ("mixer", "in_proj"): ("embed", "mlp"),
    ("mixer", "dt_bias"): (None,), ("mixer", "A_log"): (None,),
    ("mixer", "D"): (None,),
    ("mixer", "norm"): ("mlp",),
    ("mixer", "out_proj"): ("mlp", "embed"),
    ("ssm", "mixer", "conv_w"): (None, "mlp"),
    ("ssm", "mixer", "conv_b"): ("mlp",),
    # RG-LRU
    ("mixer", "w_in_rnn"): ("embed", "rnn"),
    ("mixer", "w_in_gate"): ("embed", "rnn"),
    ("rglru", "mixer", "conv_w"): (None, "rnn"),
    ("rglru", "mixer", "conv_b"): ("rnn",),
    ("mixer", "w_a"): ("rnn", "rnn"), ("mixer", "b_a"): ("rnn",),
    ("mixer", "w_x"): ("rnn", "rnn"), ("mixer", "b_x"): ("rnn",),
    ("mixer", "lam"): ("rnn",),
    ("mixer", "w_out"): ("rnn", "embed"),
}


def param_specs(model: Transformer) -> dict:
    """``{parameter name: logical spec}`` of every parameter of
    ``model``, through ``convert``'s map from a port name to the
    reference's key path."""
    from repro_torch.convert import _named_leaves
    out = {}
    kinds = {}
    for layer, (group, j, i) in zip(model.layers, model.slots):
        kinds[(group, j)] = layer.kind
    for name, path, _i in _named_leaves(model):
        if len(path) == 1:
            key = path
        else:
            group = path[0]
            j = 0 if group == "prefix" else path[1]
            key = path[1:] if group == "prefix" else path[2:]
            kind = kinds[(group, j)]
            if (kind, *key) in LOGICAL_SPECS:
                key = (kind, *key)
        out[name] = LOGICAL_SPECS[key]
    return out


def abstract_init(model) -> tuple[dict, dict]:
    """(``{name: meta tensor}``, ``{name: logical spec}``) of a model or a
    ``ModelConfig`` (built on ``meta``: nothing drawn or allocated)."""
    if isinstance(model, ModelConfig):
        model = Transformer(model, device="meta")
    shapes = {name: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for name, p in model.named_parameters()}
    return shapes, param_specs(model)


def abstract_cache(model: Transformer, batch: int, max_len: int,
                   dtype=torch.bfloat16, window_bound: bool = False) -> dict:
    """The cache of ``model.init_cache`` on ``meta``."""
    return model.init_cache(batch, max_len, dtype=dtype,
                            window_bound=window_bound, device="meta")


def batch_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """The step's inputs as ``meta`` tensors: train ``tokens`` and
    ``targets``, prefill ``tokens``, decode ``token`` [B, 1] and ``pos``
    (a 0-dim int32); ``prefix_embeds`` and ``memory`` where the config
    takes them (decode: ``memory`` only)."""
    seq, gbatch, mode = SHAPES[shape_name]

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    out: dict = {}
    text = seq - cfg.prefix_embed_len
    if mode == "train":
        out["tokens"] = sds((gbatch, text), torch.int32)
        out["targets"] = sds((gbatch, text), torch.int32)
    elif mode == "prefill":
        out["tokens"] = sds((gbatch, text), torch.int32)
    else:
        out["token"] = sds((gbatch, 1), torch.int32)
        out["pos"] = sds((), torch.int32)
    if cfg.prefix_embed_len and mode != "decode":
        out["prefix_embeds"] = sds((gbatch, cfg.prefix_embed_len,
                                    cfg.d_model), torch.bfloat16)
    if cfg.cross_attn_memory_len:
        out["memory"] = sds((gbatch, cfg.cross_attn_memory_len,
                             cfg.cross_attn_memory_dim), torch.bfloat16)
    return out
