"""moonshot-v1-16b-a3b (Moonlight) — 64-expert top-6 fine-grained MoE.
[hf:moonshotai/Moonlight-16B-A3B]

48L d_model=2048 16H (kv=16, head_dim=128) d_ff=1408/expert vocab=163840.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    n_experts=64,
    experts_per_token=6,
    rope_theta=50000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=48,
    vocab=256,
    n_experts=8,
    experts_per_token=2,
    # cf = E/k -> drop-free capacity for exact smoke tests (prod keeps 1.25).
    moe_capacity_factor=4.0,
    remat="none",
)
