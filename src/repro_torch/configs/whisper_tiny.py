"""whisper-tiny [audio]: 4L(enc)+4L(dec) d_model=384 6H (kv=6) d_ff=1536
vocab=51865 — encoder-decoder; conv frontend STUB.  [arXiv:2212.04356]

``input_specs`` provides precomputed audio-frame embeddings
(B, 1500, 384) — the output of the stubbed conv1d×2 frontend at 50 Hz over
30 s of audio.  The encoder is bidirectional with sinusoidal positions;
the decoder is causal with cross-attention every layer (decoder positions
use RoPE here — a documented substitution for Whisper's learned absolute
embeddings, irrelevant to the systems behaviour being measured).
MLP kind is plain GELU (no gating), as in the original.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865,
    enc_layers=4, enc_seq=1500,
    mlp_kind="gelu", rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, d_model=48, n_heads=2, n_kv_heads=2, head_dim=24,
        d_ff=96, vocab=256,
        enc_layers=2, enc_seq=32,
        mlp_kind="gelu", remat="none",
    )
