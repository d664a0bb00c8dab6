"""musicgen-large — decoder-only over EnCodec tokens + T5 cross-attention.

[arXiv:2306.05284; hf]  Backbone only: EnCodec frame embeddings and the T5
text memory are stubs from ``input_specs`` (DESIGN.md §5).  Positional
encoding adapted to rope (original uses sinusoidal) — documented deviation.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    pattern=("global",),
    rope_theta=10000.0,
    tie_embeddings=False,
    cross_attn_memory_len=256,      # T5 text-conditioning stub
    cross_attn_memory_dim=2048,
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=128, activation="gelu", pattern=("global",),
    tie_embeddings=False, cross_attn_memory_len=16, cross_attn_memory_dim=64,
    max_seq_len=128,
)
