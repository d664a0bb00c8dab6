"""mamba2-1.3b — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]

Vocab padded 50280 -> 50432 (x16 TP divisibility; DESIGN.md §5).  Constant-
size recurrent state => runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig, SsmConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,                         # mamba2 blocks have no MLP
    vocab_size=50432,               # padded from 50280
    pattern=("ssm",),
    ssm=SsmConfig(d_state=128, head_dim=64, n_groups=1, d_conv=4, expand=2,
                  chunk=256),
    tie_embeddings=True,
    max_seq_len=1048576,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, head_dim=16, d_ff=0,
    vocab_size=256, pattern=("ssm",),
    ssm=SsmConfig(d_state=16, head_dim=16, n_groups=1, d_conv=4, expand=2,
                  chunk=32),
    max_seq_len=256,
)
