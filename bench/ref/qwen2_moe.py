"""A plain float32 Qwen1.5-MoE-A2.7B (``Qwen2MoeForCausalLM``,
https://huggingface.co/Qwen/Qwen1.5-MoE-A2.7B): the reference the qwen2-moe
serving cell is held to, its FLOP count and the bound of the grouped
expert kernel (K6).

Written from the published model: each of the layers is
``h + attn(rmsnorm(h))`` then ``h + moe(rmsnorm(h))``.  Attention: q, k, v
projections with biases, no bias on the output projection, all heads
full (16 of 128, no grouping), RoPE on q and k (half-split rotation,
theta from the configuration), causal softmax over every earlier
position.  MoE: a router over the routed experts, the softmax over all of
them, the top-k experts kept with their softmax weights as they are
(``norm_topk_prob`` false: not renormalised), each a SwiGLU
``down(silu(x gate) * (x up))``; beside them one shared SwiGLU expert of
the published shared width, scaled by ``sigmoid(x @ shared_gate)``.  No
capacity: every token reaches its k experts.  A final rmsnorm and an
untied output projection give the logits.

Departures, each also the program's: the routed experts are held padded
to a multiple of 16 with zero weights (60 to 64), which the router never
scores; the router's weights are float32 (published: a bfloat16 linear
layer); the shared expert's width is given as ``n_shared_experts`` x
``d_ff_shared`` (one of 5,632 here).  And the reference's own: everything
is float32 with TF32 off, the whole sequence at once (no cache).  It runs
layer by layer, each layer's weights cast to float32 as it runs (the
whole model in float32 would not fit beside anything).

``matmul`` is the one matrix product of the projections, the router, the
experts and the output projection, so that ``fp8_matmul`` (inputs
rounded to float8 e4m3, float32 accumulation) gives the lower-precision
control.  Weights are a dict ``name -> tensor`` made by ``make_weights``
from a seed, named as the program's leaves (``embed.tok``,
``embed.lm_head``, ``final_norm.scale``, ``blocks.<i>.norm1.scale``,
``blocks.<i>.attn.<wq|wk|wv|wo|bq|bk|bv>``, ``blocks.<i>.norm2.scale``,
``blocks.<i>.moe.<router|gate|up|down|shared_gate>``,
``blocks.<i>.moe.shared.<gate|up|down>``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from bench.ref.mamba2 import fp8_matmul, matmul, rmsnorm  # noqa: F401
from bench.ref import peaks

EP_PAD = 16
BIAS_SCALE = 0.1          # q/k/v biases, N(0, 0.1^2)


def padded_experts(m: dict) -> int:
    return -(-m["n_experts"] // EP_PAD) * EP_PAD


def shared_width(m: dict) -> int:
    return m["n_shared_experts"] * m["d_ff_shared"]


def shapes(m: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each leaf's shape and the deviation it is drawn at (0: all ones,
    a norm), in the order ``make_weights`` draws them."""
    d, v, ff = m["d_model"], m["vocab"], m["d_ff_expert"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    e, fs = padded_experts(m), shared_width(m)
    sd = 1 / math.sqrt(d)
    out = {"embed.tok": ((v, d), 0.02), "embed.lm_head": ((d, v), sd),
           "final_norm.scale": ((d,), 0.0)}
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out.update({
            p + "norm1.scale": ((d,), 0.0),
            p + "attn.wq": ((d, q), sd), p + "attn.wk": ((d, kv), sd),
            p + "attn.wv": ((d, kv), sd),
            p + "attn.wo": ((q, d), 1 / math.sqrt(q)),
            p + "attn.bq": ((q,), BIAS_SCALE),
            p + "attn.bk": ((kv,), BIAS_SCALE),
            p + "attn.bv": ((kv,), BIAS_SCALE),
            p + "norm2.scale": ((d,), 0.0),
            p + "moe.router": ((d, m["n_experts"]), sd),
            p + "moe.gate": ((e, d, ff), sd), p + "moe.up": ((e, d, ff), sd),
            p + "moe.down": ((e, ff, d), 1 / math.sqrt(ff)),
            p + "moe.shared.gate": ((d, fs), sd),
            p + "moe.shared.up": ((d, fs), sd),
            p + "moe.shared.down": ((fs, d), 1 / math.sqrt(fs)),
            p + "moe.shared_gate": ((d, 1), sd)})
    return out


def leaf_dtype(name: str, m: dict) -> torch.dtype:
    if name.endswith(".router"):
        return torch.float32
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["dtype"]]


def iter_weights(m: dict, seed: int, device
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, drawn from ``seed`` on ``device`` in
    the dtype it is served in, one leaf at a time (so a caller can copy
    each away before the next is made): normal matrices at 1/sqrt(fan-in)
    (token table 0.02), q/k/v biases at ``BIAS_SCALE``, norms 1, the
    padded experts' weights 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = m["n_experts"]
    for name, (shape, scale) in shapes(m).items():
        dt = leaf_dtype(name, m)
        if scale == 0.0:
            yield name, torch.ones(shape, dtype=dt, device=device)
            continue
        real = (n,) + shape[1:] if name.rsplit(".", 1)[-1] in (
            "gate", "up", "down") and ".shared." not in name else shape
        t = torch.randn(real, generator=g, device=device).mul_(scale).to(dt)
        if real != shape:
            t = torch.cat([t, t.new_zeros((shape[0] - n,) + shape[1:])])
        yield name, t


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``iter_weights`` in one dict."""
    return dict(iter_weights(m, seed, device))


def _rope(x, positions, theta: float):
    """Half-split rotation of x (B, S, H, D) at integer ``positions`` (S,)."""
    d = x.shape[-1]
    freqs = (1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                           device=x.device) / d))).float()
    ang = positions.float()[:, None] * freqs                 # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w, i: int, m: dict, x, mm):
    p = f"blocks.{i}.attn."
    b, s, _ = x.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = (mm(x, w[p + "wq"]) + w[p + "bq"]).view(b, s, h, hd)
    k = (mm(x, w[p + "wk"]) + w[p + "bk"]).view(b, s, kv, hd)
    v = (mm(x, w[p + "wv"]) + w[p + "bv"]).view(b, s, kv, hd)
    pos = torch.arange(s, device=x.device)
    q, k = _rope(q, pos, m["rope_theta"]), _rope(k, pos, m["rope_theta"])
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), dim=-1)
    del scores
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
    return mm(out, w[p + "wo"])


def moe(w, i: int, m: dict, x, mm):
    """The routed experts (softmax over all, top-k as they are) and the
    gated shared expert, over x (B, S, d)."""
    p = f"blocks.{i}.moe."
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    probs = torch.softmax(mm(x, w[p + "router"]), dim=-1)
    top_w, top_e = torch.topk(probs, m["top_k"], dim=-1)
    y = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = F.silu(mm(xe, w[p + "gate"][e])) * mm(xe, w[p + "up"][e])
        y.index_add_(0, tok, mm(he, w[p + "down"][e])
                     * top_w[tok, slot][:, None])
    sh = mm(F.silu(mm(x, w[p + "shared.gate"])) * mm(x, w[p + "shared.up"]),
            w[p + "shared.down"])
    y = y + torch.sigmoid(mm(x, w[p + "shared_gate"])) * sh
    return y.reshape(shape)


def forward(w, m: dict, tokens: torch.Tensor, mm=matmul,
            first: int = 0) -> torch.Tensor:
    """Logits (B, S - first, vocab), float32, of positions ``first`` on,
    from the weights ``w`` in any dtype (each layer's cast to float32 as
    it runs)."""
    h = w["embed.tok"][tokens.long()].float()
    eps = m["norm_eps"]
    for i in range(m["n_layers"]):
        pre = f"blocks.{i}."
        lw = {k: v.float() for k, v in w.items() if k.startswith(pre)}
        h = h + attention(lw, i, m, rmsnorm(h, lw[pre + "norm1.scale"], eps),
                          mm)
        h = h + moe(lw, i, m, rmsnorm(h, lw[pre + "norm2.scale"], eps), mm)
        del lw
    h = rmsnorm(h[:, first:], w["final_norm.scale"].float(), eps)
    return mm(h, w["embed.lm_head"].float())


# ------------------------------------------------------------ FLOP counts
def layer_matmul_params(m: dict) -> int:
    """The weights a token meets in one layer's products: attention's
    four projections, the router, its k experts, the shared expert and its
    gate."""
    d = m["d_model"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    return (2 * d * q + 2 * d * kv + d * m["n_experts"]
            + m["top_k"] * 3 * d * m["d_ff_expert"]
            + 3 * d * shared_width(m) + d)


def prefill_flops(m: dict, batch: int, prompt: int) -> float:
    """A prefill of ``batch`` prompts of ``prompt`` tokens: every token's
    products, 4 D H a causal (query, key) pair of attention (both
    products), and the output projection at the last position only (the
    program computes no other).  A multiply-add counts 2."""
    hd = m["head_dim"] * m["n_heads"]
    per_seq = (2 * prompt * m["n_layers"] * layer_matmul_params(m)
               + m["n_layers"] * 4 * hd * prompt * (prompt + 1) // 2
               + 2 * m["d_model"] * m["vocab"])
    return float(batch * per_seq)


def decode_flops(m: dict, batch: int, pos: int) -> float:
    """One decode step of ``batch`` sequences at position ``pos`` (keys
    0 .. pos): the products, attention over pos + 1 keys, the output
    projection."""
    hd = m["head_dim"] * m["n_heads"]
    per_seq = (2 * m["n_layers"] * layer_matmul_params(m)
               + m["n_layers"] * 4 * hd * (pos + 1)
               + 2 * m["d_model"] * m["vocab"])
    return float(batch * per_seq)


# ----------------------------------------------------------------- K6 bound
def k6_bytes(m: dict, rows: int, active: int, esize: int = 2) -> float:
    """Bytes K6 must move over calls with ``rows`` rows and ``active``
    (call, expert) pairs with at least one row in all: each such expert's
    gate, up and down weights read once a call, and the rows in and
    out."""
    d, ff = m["d_model"], m["d_ff_expert"]
    return float(active * 3 * d * ff * esize + 2 * rows * d * esize)


def k6_flops(m: dict, rows: int) -> float:
    """6 d ff a row: the gate, up and down products."""
    return float(6 * rows * m["d_model"] * m["d_ff_expert"])


def k6_bound_s(m: dict, rows: int, active: int) -> float:
    """The least time the card could take for those calls: the larger of
    the bytes over the HBM rate and the operations over the bf16 peak (the
    sum of each call's bound where every call is bound alike, as every
    decode call is by its bytes)."""
    return max(k6_bytes(m, rows, active) / peaks.HBM_BYTES_PER_S,
               k6_flops(m, rows) / peaks.BF16_FLOPS)
