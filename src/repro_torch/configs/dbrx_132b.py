"""dbrx-132b — 16-expert top-4 fine-grained MoE. [hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=10752/expert vocab=100352.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    experts_per_token=4,
    rope_theta=500000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    n_experts=4,
    experts_per_token=2,
    # cf = E/k -> capacity == group size: provably drop-free, so smoke tests
    # (decode == teacher forcing) are exact. Production keeps cf=1.25.
    moe_capacity_factor=2.0,
    remat="none",
)
