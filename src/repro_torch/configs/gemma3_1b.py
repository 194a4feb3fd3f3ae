"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global interleaving, 128k context.
[hf:google/gemma-3-1b-pt]

Pattern period = (local ×5, attn); 26 layers = 4 full periods + 2 tail
local layers.  Sliding window 512 (gemma3-1b HF config).  GeGLU MLP,
head_dim 256 (q_dim 1024 ≠ d_model, as in the real config).
Runs the long_500k cell: only the 4 global layers keep a full-length KV
cache (sequence-sharded); local layers cache one window.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    window=512, layer_pattern=("local", "local", "local", "local",
                               "local", "attn"),
    mlp_kind="geglu", rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=8, d_model=48, n_heads=2, n_kv_heads=1, head_dim=24,
        d_ff=96, vocab=256,
        window=16, layer_pattern=("local", "local", "attn"),
        mlp_kind="geglu", remat="none",
    )
