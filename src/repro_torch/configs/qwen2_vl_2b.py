"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone only; the vision frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings (B, img_tokens, d_model) and the (3, B, S)
M-RoPE position ids (temporal / height / width components).
"""
from repro_torch.configs.base import ModelConfig

IMG_TOKENS = 1024      # stubbed patch-embedding tokens per sample

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936,
    qkv_bias=True, mrope=True, rope_theta=1_000_000.0,
    img_tokens=IMG_TOKENS, mlp_kind="swiglu",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        qkv_bias=True, mrope=True, img_tokens=8, mlp_kind="swiglu",
        remat="none",
    )
