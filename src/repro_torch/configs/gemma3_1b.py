"""gemma3-1b — 5:1 local:global sliding-window attention, 262k vocab.

[hf:google/gemma-3-1b-pt; unverified]
26 layers = 4 scanned (5 local + 1 global) periods + a 2-layer local tail
(config.tail — keeps the traced HLO at 8 blocks, not 26).  Single rope theta
(1M) is used for both local and global layers — a documented simplification.
"""
from repro_torch.models.config import ModelConfig

_PATTERN = ("local",) * 5 + ("global",)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    activation="gelu_glu",
    pattern=_PATTERN,
    window=512,
    rope_theta=1e6,
    use_qk_norm=True,
    use_post_norm=True,
    embed_scale=True,
    max_seq_len=131072,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-1b-smoke",
    family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, activation="gelu_glu",
    pattern=("local",) * 5 + ("global",), window=16,
    use_qk_norm=True, use_post_norm=True, embed_scale=True, max_seq_len=128,
)
