"""nemotron-4-15b — dense GQA with squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    activation="squared_relu",
    pattern=("global",),
    rope_theta=10000.0,
    tie_embeddings=False,
    max_seq_len=4096,
)

SMOKE_CONFIG = ModelConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, activation="squared_relu", pattern=("global",),
    tie_embeddings=False, max_seq_len=128,
)
