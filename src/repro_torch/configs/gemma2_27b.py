"""gemma2-27b — alternating local/global attention + logit softcaps.

[arXiv:2408.00118; hf]  attn softcap 50, final softcap 30, query scale
1/sqrt(d_model/n_heads) = 144^-0.5 (not head_dim^-0.5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    activation="gelu_glu",
    pattern=("local", "global"),
    window=4096,
    rope_theta=10000.0,
    use_post_norm=True,
    embed_scale=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,
    max_seq_len=8192,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-27b-smoke",
    family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, activation="gelu_glu",
    pattern=("local", "global"), window=16, use_post_norm=True,
    embed_scale=True, attn_logit_softcap=50.0, final_logit_softcap=30.0,
    attn_scale=16.0 ** -0.5, max_seq_len=128,
)
