"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

d_ff=1408 is the routed-expert intermediate size (HF
``moe_intermediate_size``); the 4 shared experts of 1408 each give the HF
``shared_expert_intermediate_size`` of 5632.  60 experts are zero-padded
to 64 for 16-way expert parallelism (router scores real experts only).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=5632, vocab=151936,
    n_experts=60, top_k=4, d_ff_expert=1408,
    n_shared_experts=4, d_ff_shared=1408,
    mlp_kind="swiglu", rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        n_experts=6, top_k=2, d_ff_expert=32,
        n_shared_experts=2, d_ff_shared=32,
        mlp_kind="swiglu", remat="none", moe_capacity_factor=8.0,
    )
