"""mamba2-780m — SSD (state-space duality), attention-free. [arXiv:2405.21060]

48L d_model=1536 vocab=50280 ssm_state=128; expand=2 -> d_inner=3072,
head_dim=64 -> 48 SSM heads, 1 group (matching the published 780m config).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attention="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    vocab=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    remat="none",
)
