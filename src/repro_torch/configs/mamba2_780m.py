"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

d_inner = 2·d_model = 3072, head_dim 64 → 48 SSD heads; conv width 4;
chunked SSD with chunk 128 for training; O(1) state decode → runs the
long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280,
    layer_pattern=("ssm",),
    ssm_state=128, d_inner=3072, ssm_heads=48, ssm_head_dim=64,
    conv_width=4, ssm_chunk=128,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=1, n_kv_heads=1, head_dim=16,
        d_ff=0, vocab=256,
        layer_pattern=("ssm",),
        ssm_state=16, d_inner=128, ssm_heads=8, ssm_head_dim=16,
        conv_width=4, ssm_chunk=8, remat="none",
    )
