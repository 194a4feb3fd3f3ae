"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1:2 attn:recurrent pattern.
[arXiv:2402.19427]

Pattern period (rglru, rglru, local): 38 layers = 12 periods + 2 tail
rglru layers.  Sliding window 2048, lru_width = d_model = 4096, GeGLU MLP
in every block.  O(1) recurrent state + windowed attention → runs the
long_500k decode cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    layer_pattern=("rglru", "rglru", "local"), window=2048,
    lru_width=4096, mlp_kind="geglu", rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab=256,
        layer_pattern=("rglru", "rglru", "local"), window=16,
        lru_width=64, mlp_kind="geglu", remat="none",
    )
