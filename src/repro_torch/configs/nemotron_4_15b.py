"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP (no gate).  [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000,
    mlp_kind="squared_relu", rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=256, vocab=256,
        mlp_kind="squared_relu", remat="none",
    )
