"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8 — trillion-parameter MoE.  [arXiv:2501.kimi2]

Interpretation of the assigned "d_ff=2048": the routed-expert intermediate
size (matches the public K2 config ``moe_intermediate_size: 2048``).  Per
the K2 paper: the first layer is dense (``first_k_dense_replace: 1``) with
dense intermediate 18432, one shared expert of 2048, 60 MoE layers...
here 61 layers = 1 dense + 60 MoE.  384 experts divide the 16-way model
axis exactly (24 experts/shard).  Assignment specifies GQA kv=8 (the real
model uses MLA; we follow the assignment).

Scale note: ~1.03e12 params — needs FSDP sharding over the data axis to
fit; see EXPERIMENTS.md §Dry-run for the per-device memory accounting.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=18432, vocab=163840,
    n_experts=384, top_k=8, d_ff_expert=2048,
    n_shared_experts=1, d_ff_shared=2048,
    first_k_dense=1,
    mlp_kind="swiglu", rope_theta=50_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=256,
        n_experts=8, top_k=2, d_ff_expert=32,
        n_shared_experts=1, d_ff_shared=32,
        first_k_dense=1,
        mlp_kind="swiglu", remat="none", moe_capacity_factor=8.0,
    )
