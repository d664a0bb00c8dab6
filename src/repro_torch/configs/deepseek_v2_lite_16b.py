"""deepseek-v2-lite-16b — MLA (kv_lora 512) + MoE 64 routed top-6, 2 shared.

[arXiv:2405.04434; hf]  Layer 0 is a dense MLP (first_k_dense=1); the MLA
cache stores the 576-wide latent per token instead of full K/V.
"""
from repro_torch.models.config import MlaConfig, ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,                     # dense prefix layer width
    vocab_size=102400,
    activation="silu_glu",
    pattern=("global",),
    rope_theta=10000.0,
    moe=MoeConfig(n_experts=64, top_k=6, expert_d_ff=1408,
                  n_shared_experts=2, shared_d_ff=1408,
                  norm_topk=True, first_k_dense=1),
    mla=MlaConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, activation="silu_glu", pattern=("global",),
    moe=MoeConfig(n_experts=8, top_k=2, expert_d_ff=32, n_shared_experts=1,
                  shared_d_ff=32, norm_topk=True, capacity_factor=8.0, first_k_dense=1),
    mla=MlaConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16),
    max_seq_len=128,
)
