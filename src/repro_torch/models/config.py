"""Model configuration covering every assigned architecture family.

A copy of ``repro.models.config`` (pure dataclasses), kept here so that the
port never imports the JAX package.  The port's ``Transformer`` runs every
family below.

One ``ModelConfig`` describes dense / MoE / MLA / SSM / hybrid / vlm / audio
decoder stacks.  Layer heterogeneity (local vs global attention, recurrent vs
attention blocks, dense-then-MoE) is expressed as a repeating ``pattern`` of
block kinds; the transformer scans over pattern *periods* with stacked
weights, so a 94-layer model still traces a single period.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Sequence

BlockKind = Literal["global", "local", "rglru"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    first_k_dense: int = 0          # leading dense layers (deepseek-v2)
    router_aux_weight: float = 0.001
    group_size: int = 512           # routing-group tokens (bounds dispatch)


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RglruConfig:
    d_rnn: int = 2560               # lru width
    d_conv: int = 4
    block_width_mult: int = 3       # gated-mlp expansion in recurrent block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    activation: Literal["silu_glu", "gelu_glu", "squared_relu", "gelu"] = "silu_glu"
    pattern: Sequence[BlockKind] = ("global",)  # repeats to n_layers
    window: int = 4096                      # for "local" blocks
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    use_qk_norm: bool = False
    use_post_norm: bool = False             # gemma sandwich norms
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    embed_scale: bool = False               # gemma: embeddings * sqrt(d)
    tie_embeddings: bool = True
    attn_scale: Optional[float] = None      # override 1/sqrt(head_dim)
    moe: Optional[MoeConfig] = None
    mla: Optional[MlaConfig] = None
    ssm: Optional[SsmConfig] = None
    rglru: Optional[RglruConfig] = None
    # modality stubs (DESIGN.md §5): precomputed frontend embeddings
    prefix_embed_len: int = 0               # vlm: image patch embeddings
    cross_attn_memory_len: int = 0          # audio: text-encoder memory
    cross_attn_memory_dim: int = 0
    cross_attn_every: int = 1               # cross-attn in every k'th layer
    max_seq_len: int = 131072
    dtype: str = "bfloat16"

    # ------------------------------------------------------------ helpers --

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    def layer_kinds(self) -> list[BlockKind]:
        p = list(self.pattern)
        reps = -(-self.n_layers // len(p))
        return (p * reps)[: self.n_layers]

    @property
    def n_periods(self) -> int:
        body = self.n_layers - (self.moe.first_k_dense if self.moe else 0)
        return body // self.period

    @property
    def tail(self) -> tuple:
        """Leftover layers when n_layers isn't a period multiple: the first
        ``body % period`` pattern entries run once after the scanned periods
        (gemma3: 26 = 4×(5L+1G) + 2L; recurrentgemma: 26 = 8×(R,R,A) + R,R)."""
        body = self.n_layers - (self.moe.first_k_dense if self.moe else 0)
        return tuple(self.pattern[: body % self.period])

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "ssm":
            assert self.ssm is not None and all(k == "rglru" for k in []) or True
        _ = self.n_periods  # divisibility check

    # -------------------------------------------------------- param count --

    def param_count(self) -> int:
        """Exact parameter count (used for 6·N·D roofline bookkeeping)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        return _count_params(self, active_only=True)


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    glu = cfg.activation in ("silu_glu", "gelu_glu")
    return cfg.d_model * d_ff * (3 if glu else 2)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim_
    if cfg.mla is not None:
        m = cfg.mla
        q = cfg.d_model * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
        dkv = cfg.d_model * (m.kv_lora_rank + m.qk_rope_dim)
        up = m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
        o = cfg.n_heads * m.v_head_dim * cfg.d_model
        return q + dkv + up + o
    qkv = cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
    return qkv + cfg.n_heads * hd * cfg.d_model


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    in_p = cfg.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
    conv = s.d_conv * conv_dim + conv_dim
    extra = n_h * 2 + d_in  # A_log, D, norm
    out_p = d_in * cfg.d_model
    return in_p + conv + extra + out_p


def _rglru_params(cfg: ModelConfig) -> int:
    r = cfg.rglru
    d, dr = cfg.d_model, r.d_rnn
    proj = d * dr * 2 + dr * d                    # two in-branches + out
    conv = r.d_conv * dr + dr
    gates = 2 * dr * dr + 2 * dr + dr             # Wx, Wa + biases + Λ
    return proj + conv + gates


def _block_params(cfg: ModelConfig, kind: BlockKind, layer_idx: int) -> int:
    d = cfg.d_model
    norms = d * (4 if cfg.use_post_norm else 2)
    if kind == "rglru":
        mixer = _rglru_params(cfg)
    elif cfg.family == "ssm":
        mixer = _ssm_params(cfg)
        return mixer + d  # single pre-norm, no mlp in mamba2 blocks
    else:
        mixer = _attn_params(cfg)
        if cfg.use_qk_norm:
            mixer += 2 * cfg.head_dim_
    if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
        m = cfg.moe
        mlp = (m.n_experts * _mlp_params(cfg, m.expert_d_ff)
               + d * m.n_experts
               + (m.n_shared_experts * _mlp_params(
                   cfg, m.shared_d_ff or m.expert_d_ff)))
    else:
        mlp = _mlp_params(cfg, cfg.d_ff)
    cross = 0
    if cfg.cross_attn_memory_len and layer_idx % cfg.cross_attn_every == 0:
        hd = cfg.head_dim_
        cross = (d * cfg.n_heads * hd + 2 * cfg.cross_attn_memory_dim *
                 cfg.n_kv_heads * hd + cfg.n_heads * hd * d + d)
    return mixer + mlp + norms + cross


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    total += cfg.d_model  # final norm
    if cfg.prefix_embed_len:
        total += 0  # frontend is a stub
    for i, kind in enumerate(cfg.layer_kinds()):
        p = _block_params(cfg, kind, i)
        if (active_only and cfg.moe is not None
                and i >= cfg.moe.first_k_dense and kind != "rglru"
                and cfg.family == "moe"):
            m = cfg.moe
            full_experts = m.n_experts * _mlp_params(cfg, m.expert_d_ff)
            active_experts = m.top_k * _mlp_params(cfg, m.expert_d_ff)
            p = p - full_experts + active_experts
        total += p
    return total
