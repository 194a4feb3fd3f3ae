"""Floating-point operations of a mamba2 model, from the configuration's
published sizes alone (not from the program): the products of the
projections, the output product (the token table, tied), the depthwise convolution and the SSD.
A multiply-add counts 2.  The SSD counts the chunked algorithm's four
products at chunk Q, whole Q x Q blocks (as the algorithm computes them):
C B^T (2 Q N a token), its weighted product with x (2 Q P H), the chunk
states (2 N P H) and their read-out (2 N P H).  The token table is a
lookup, not a product, and counts nothing; nor do norms, gates and
element-wise passes.  A training step counts forward and backward as
three forwards (recompute not counted)."""
from __future__ import annotations


def matmul_params(m: dict) -> int:
    d, di, ns, nh = m["d_model"], m["d_inner"], m["ssm_state"], \
        m["ssm_heads"]
    per_layer = d * (2 * di + 2 * ns + nh) + di * d
    return m["n_layers"] * per_layer + d * m["vocab"]


def _conv(m: dict) -> int:
    return 2 * m["conv_width"] * (m["d_inner"] + 2 * m["ssm_state"])


def forward_per_token(m: dict) -> float:
    """A full-sequence forward, per token."""
    q, n, p, h = m["ssm_chunk"], m["ssm_state"], m["ssm_head_dim"], \
        m["ssm_heads"]
    ssd = 2 * q * n + 2 * q * p * h + 4 * n * p * h
    return 2 * matmul_params(m) + m["n_layers"] * (ssd + _conv(m))


def decode_per_token(m: dict) -> float:
    """One recurrent decode step, per sequence: the state update and its
    read-out (4 N P H a layer) instead of the chunked products."""
    n, p, h = m["ssm_state"], m["ssm_head_dim"], m["ssm_heads"]
    return 2 * matmul_params(m) + m["n_layers"] * (4 * n * p * h + _conv(m))


def train_step(m: dict, tokens: int) -> float:
    return 3 * forward_per_token(m) * tokens
