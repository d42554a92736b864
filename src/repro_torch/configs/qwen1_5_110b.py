"""qwen1.5-110b — dense GQA decoder with QKV bias. [hf:Qwen/Qwen1.5-110B]

80L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=49152 vocab=152064.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
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
