"""qwen3-moe-235b-a22b — 128 experts top-8, qk-norm. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                      # (all layers MoE; kept for bookkeeping)
    vocab_size=151936,
    activation="silu_glu",
    pattern=("global",),
    rope_theta=1e6,
    use_qk_norm=True,
    tie_embeddings=False,
    moe=MoeConfig(n_experts=128, top_k=8, expert_d_ff=1536,
                  n_shared_experts=0, norm_topk=True, first_k_dense=0),
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, activation="silu_glu", pattern=("global",),
    use_qk_norm=True, tie_embeddings=False,
    moe=MoeConfig(n_experts=8, top_k=2, expert_d_ff=32, norm_topk=True, capacity_factor=8.0),
    max_seq_len=128,
)
