"""recurrentgemma-2b — Griffin: RG-LRU + local attention, 2:1. [arXiv:2402.19427; hf]

26 layers = 8 scanned (rglru, rglru, local) periods + a 2-layer rglru tail
(config.tail).  Bounded state (RG-LRU h + 2048-window KV) => runs long_500k.
"""
from repro_torch.models.config import ModelConfig, RglruConfig

_PATTERN = ("rglru", "rglru", "local")

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="gelu_glu",
    pattern=_PATTERN,
    window=2048,
    rope_theta=10000.0,
    embed_scale=True,
    rglru=RglruConfig(d_rnn=2560, d_conv=4),
    max_seq_len=1048576,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=256, activation="gelu_glu",
    pattern=("rglru", "rglru", "local"), window=16, embed_scale=True,
    rglru=RglruConfig(d_rnn=64, d_conv=4), max_seq_len=256,
)
