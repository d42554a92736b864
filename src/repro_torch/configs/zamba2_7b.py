"""zamba2-7b — Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242]

81L d_model=3584 ssm_state=64; shared attention block (32H full MHA,
head_dim=112, d_ff=14336 MLP) applied after every 6 mamba layers (13
applications, 3 trailing mamba layers). Runs `long_500k` (hybrid: SSM state
is O(1); the shared-attn KV is seq-sharded over the model axis).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    hybrid_attn_every=6,
)

SMOKE = CONFIG.scaled(
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    hybrid_attn_every=2,
    remat="none",
)
