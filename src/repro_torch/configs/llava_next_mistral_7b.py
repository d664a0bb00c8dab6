"""llava-next-mistral-7b — Mistral-7B backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Backbone only (assignment): the CLIP tower is a stub; ``input_specs`` feeds
precomputed anyres patch embeddings (5 tiles × 576 patches = 2880 tokens).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    activation="silu_glu",
    pattern=("global",),
    rope_theta=1e6,
    prefix_embed_len=2880,       # anyres: 5 tiles x 24x24 patches
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, activation="silu_glu", pattern=("global",),
    prefix_embed_len=8, max_seq_len=128,
)
