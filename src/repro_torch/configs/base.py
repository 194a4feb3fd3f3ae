"""Unified model configuration covering all 10 assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # --- attention flavour ---
    qk_norm: bool = False         # qwen3
    qkv_bias: bool = False        # qwen2 / qwen2-vl
    rope_theta: float = 10_000.0
    mrope: bool = False           # qwen2-vl M-RoPE (3-component positions)
    window: int = 0               # sliding-window size for 'local' layers
    pos_kind: str = "rope"        # rope | sinusoid (whisper encoder/decoder)

    # --- block pattern: kinds repeated to n_layers ---
    # kinds: attn (global), local (sliding window), rglru, ssm
    layer_pattern: Tuple[str, ...] = ("attn",)

    # --- mlp ---
    mlp_kind: str = "swiglu"      # swiglu | geglu | squared_relu | gelu

    # --- moe (family == moe) ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    first_k_dense: int = 0        # kimi-k2: first layer dense
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    # dropless routing (every assignment kept, prefill and decode alike:
    # a sort by expert and the grouped expert kernel K6), in place of the
    # capacity-bounded buffer
    moe_dropless: bool = False
    # renormalise the top-k router weights to sum 1 (qwen2-moe publishes
    # norm_topk_prob false: the softmax over all experts, kept as it is)
    moe_norm_topk: bool = True
    # scale the shared experts' output by sigmoid(x @ shared_gate), a
    # (d_model, 1) leaf (qwen2-moe's shared_expert_gate)
    moe_shared_gate: bool = False

    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0
    conv_width: int = 4
    ssm_chunk: int = 128

    # --- rg-lru (recurrentgemma) ---
    lru_width: int = 0

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500           # precomputed audio-frame embeddings (stub)

    # --- vlm (qwen2-vl) ---
    img_tokens: int = 0           # precomputed patch embeddings (stub)

    # --- numerics / misc ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # remat policy for the layer scan: none | dots | full
    remat: str = "dots"
    # dtype the (B, S, vocab) logits are materialized in; CE math is f32
    # either way (conversions fuse into the reductions).  "bfloat16"
    # halves the largest activation tensor's HBM traffic (§Perf H1).
    logits_dtype: str = "float32"
    # streaming-attention block sizes: larger block_q => fewer passes over
    # the (replicated-KV) cache => less HBM traffic (§Perf H2)
    attn_block_q: int = 512
    attn_block_k: int = 512
    # dtype attention scores/probabilities are materialized in between the
    # QK^T and PV einsums (softmax stats stay f32).  "bfloat16" halves the
    # dominant S²-shaped HBM traffic of the HLO attention — the same trick
    # a fused flash kernel plays inside VMEM (§Perf H4).
    attn_scores_dtype: str = "float32"
    # pad the vocab dim to a multiple (0 = off) so embeddings/logits shard
    # over the model axis even for awkward vocab sizes (§Perf H3; padded
    # logit lanes are masked to -inf in lm_logits)
    pad_vocab_multiple: int = 0
    # diagnostic: skip the sequence mixer (attention/ssm/rglru) entirely —
    # used by the roofline ablation to attribute HBM bytes to attention
    # (never a training configuration)
    ablate_mixer: bool = False

    # ---------------------------------------------------------- helpers
    @property
    def padded_vocab(self) -> int:
        if self.pad_vocab_multiple <= 1:
            return self.vocab
        m = self.pad_vocab_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def pattern_layers(self) -> Tuple[str, ...]:
        """Per-layer kind list of length n_layers (pattern tiled)."""
        p = self.layer_pattern
        reps = (self.n_layers + len(p) - 1) // len(p)
        return tuple((p * reps)[: self.n_layers])

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def n_tail(self) -> int:
        """Layers not covered by full periods (unrolled)."""
        return self.n_layers - self.n_periods * len(self.layer_pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def moe_layer(self, layer_idx: int) -> bool:
        return self.family == "moe" and layer_idx >= self.first_k_dense

    # Parameter count (analytic; used by roofline MODEL_FLOPS and memory
    # accounting).  Counts all trainable params.
    def param_count(self, active_only: bool = False) -> int:
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb + d                              # final norm
        for i, kind in enumerate(self.pattern_layers):
            total += 2 * d                           # two block norms
            if kind in ("attn", "local"):
                total += d * self.q_dim + 2 * d * self.kv_dim \
                    + self.q_dim * d
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
                if self.qk_norm:
                    total += 2 * self.head_dim
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * d + 4 * w \
                    + 2 * w * (self.conv_width)      # temporal conv
            elif kind == "ssm":
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + nh) \
                    + self.conv_width * (di + 2 * ns) + 2 * nh + di \
                    + di * d
            # mlp / moe
            if kind == "ssm":
                pass                                  # mamba2: no extra mlp
            elif self.moe_layer(i):
                e = self.n_experts
                if not active_only:
                    total += 3 * d * self.d_ff_expert * e
                else:
                    total += 3 * d * self.d_ff_expert * self.top_k
                total += d * e                        # router
                total += 3 * d * self.d_ff_shared * self.n_shared_experts
                if self.moe_shared_gate:
                    total += d
                if self.first_k_dense and i < self.first_k_dense:
                    pass
            else:
                ff = self.d_ff
                mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                total += mult * d * ff
        # encoder stack (whisper): enc_layers of attn + mlp
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        for _ in range(self.enc_layers):
            total += 2 * d + d * self.q_dim + 2 * d * self.kv_dim \
                + self.q_dim * d + mult * d * self.d_ff
        if self.family == "encdec":
            # decoder cross-attention per layer
            total += self.n_layers * (d * self.q_dim + 2 * d * self.kv_dim
                                      + self.q_dim * d + d)
        return int(total)
