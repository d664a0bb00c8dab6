"""mistral-nemo-12b — dense GQA, 128k context. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,                # explicit (not d_model / n_heads)
    d_ff=14336,
    vocab_size=131072,
    activation="silu_glu",
    pattern=("global",),
    rope_theta=1e6,
    max_seq_len=131072,
)

SMOKE_CONFIG = ModelConfig(
    name="mistral-nemo-12b-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, activation="silu_glu", pattern=("global",),
    max_seq_len=128,
)
