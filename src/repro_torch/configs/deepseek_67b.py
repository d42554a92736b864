"""deepseek-67b — llama-arch dense decoder. [arXiv:2401.02954]

95L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22016 vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=102400,
    rope_theta=10000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    remat="none",
)
