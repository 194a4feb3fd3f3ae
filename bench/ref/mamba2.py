"""A plain float32 mamba2 (arXiv:2405.21060), its loss and AdamW: the
reference the training and serving cells are held to.

Written from the published description: each layer is a pre-norm
residual block ``h + mixer(rmsnorm(h))``; the mixer projects to ``z``,
``xBC`` and ``dt``; ``xBC`` goes through a depthwise causal convolution
and SiLU; the state-space dual (SSD) recurrence
``S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t``, ``y_t = C_t S_t + D x_t``
(one group of B and C for all heads) is computed by the paper's chunked
"minimal SSD" listing (block-diagonal part, chunk states, the inter-chunk
recurrence by a segment-sum matrix, the off-diagonal part); ``y`` is gated
by ``silu(z)`` and normalised before the output projection.  A final
rmsnorm and the token table, transposed (tied, as published), give the
logits.  Everything is
float32 with TF32 off.  ``matmul`` is the one matrix product of the
projections and the output product, so that ``fp8_matmul`` (inputs rounded
to float8 e4m3 with a per-tensor scale, float32 accumulation) gives the
lower-precision control.

The weights are a dict ``name -> tensor`` made by ``make_weights`` from a
seed; the names follow the leaves of the configuration (``embed.tok``,
``final_norm.scale``, ``blocks.<i>.norm1.scale``,
``blocks.<i>.ssm.<in_proj|conv_w|conv_b|a_log|dt_bias|d_skip|norm|
out_proj>``).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# leaves kept in float32 whatever the model's dtype (the SSD's decay and
# skip parameters)
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


def shapes(m: dict) -> Dict[str, tuple]:
    d, di, ns, nh = m["d_model"], m["d_inner"], m["ssm_state"], \
        m["ssm_heads"]
    conv = di + 2 * ns
    out = {"embed.tok": (m["vocab"], d), "final_norm.scale": (d,)}
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out.update({
            p + "norm1.scale": (d,),
            p + "ssm.in_proj": (d, 2 * di + 2 * ns + nh),
            p + "ssm.conv_w": (m["conv_width"], conv),
            p + "ssm.conv_b": (conv,),
            p + "ssm.a_log": (nh,), p + "ssm.dt_bias": (nh,),
            p + "ssm.d_skip": (nh,), p + "ssm.norm": (di,),
            p + "ssm.out_proj": (di, d)})
    return out


def leaf_dtype(name: str, m: dict) -> torch.dtype:
    if name.rsplit(".", 1)[-1] in FLOAT32_LEAVES:
        return torch.float32
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["dtype"]]


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights drawn from ``seed`` on ``device`` in the dtypes they are
    served in: every normal matrix from one draw, scaled by 1/sqrt(fan-in)
    (0.02 for the token table); A from U(1, 16) and dt from log-U(1e-3,
    0.1) per head (the paper's initialisation); norms 1, conv bias 0,
    D 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    shp = shapes(m)
    scale = {"embed.tok": 0.02}
    for i in range(m["n_layers"]):
        p = f"blocks.{i}.ssm."
        scale[p + "in_proj"] = 1 / math.sqrt(m["d_model"])
        scale[p + "conv_w"] = 1 / math.sqrt(m["conv_width"])
        scale[p + "out_proj"] = 1 / math.sqrt(m["d_inner"])
    sizes = [math.prod(shp[k]) for k in scale]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    nh, n_layers = m["ssm_heads"], m["n_layers"]
    u = torch.rand((2, n_layers, nh), generator=g, device=device,
                   dtype=torch.float64)
    a_log = torch.log(1 + 15 * u[0])
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(0.1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))      # softplus^-1(dt)
    w, at = {}, 0
    for k, n in zip(scale, sizes):
        w[k] = (flat[at:at + n].view(shp[k]) * scale[k]).to(leaf_dtype(k, m))
        at += n
    del flat
    for name, s in shp.items():
        if name in w:
            continue
        leaf = name.rsplit(".", 1)[-1]
        i = int(name.split(".")[1]) if name.startswith("blocks.") else 0
        if leaf == "a_log":
            v = a_log[i]
        elif leaf == "dt_bias":
            v = dt_bias[i]
        elif leaf == "conv_b":
            v = torch.zeros(s, device=device)
        else:                                       # norms, D
            v = torch.ones(s, device=device)
        w[name] = v.to(leaf_dtype(name, m))
    return w


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale; the gradient
    passes straight through in float32 (a float8 gradient would flush to
    zero)."""
    with torch.no_grad():
        s = t.abs().amax().clamp(min=1e-30) / 448.0
        q = (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t).detach()


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product with both inputs rounded to float8 e4m3 (per-tensor
    scale), accumulated in float32: the control's precision."""
    return _fp8(a) @ _fp8(b)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i, j] = sum of x[j+1 .. i] for j <= i,
    -inf above the diagonal (the paper's stable segment sum)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    low = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return x.masked_fill(~keep, -torch.inf)


def ssd(x, a, b, c, block: int):
    """x (B, S, H, P) already times dt; a (B, S, H) = dt * A; b, c (B, S,
    N).  Returns y (B, S, H, P) without the skip term."""
    bs, s, h, p = x.shape
    pad = (-s) % block
    if pad:              # trailing positions with no input change no output
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // block
    x = x.reshape(bs, nc, block, h, p)
    b = b.reshape(bs, nc, block, -1)
    c = c.reshape(bs, nc, block, -1)
    a = a.reshape(bs, nc, block, h).permute(0, 3, 1, 2)        # B H C L
    a_cs = torch.cumsum(a, dim=-1)
    # 1. within each chunk: (C_l . B_s) exp(segsum) x_s
    w = torch.einsum("bcln,bcsn->bcls", c, b)[:, None] \
        * torch.exp(segsum(a))                               # B H C L S
    y = torch.einsum("bhcls,bcshp->bclhp", w, x)
    # 2. each chunk's final state from its own inputs
    decay = torch.exp(a_cs[..., -1:] - a_cs)                 # B H C L
    states = torch.einsum("bcln,bclhp->bchpn", b,
                          x * decay.permute(0, 2, 3, 1)[..., None])
    # 3. the state entering each chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    # 4. its contribution to each position
    y = y + torch.einsum("bcln,bchpn->bclhp", c, states) \
        * torch.exp(a_cs).permute(0, 2, 3, 1)[..., None]
    return y.reshape(bs, nc * block, h, p)[:, :s]


def mixer(w, i: int, m: dict, x, mm, block: int):
    p = f"blocks.{i}.ssm."
    di, ns, nh, hd = m["d_inner"], m["ssm_state"], m["ssm_heads"], \
        m["ssm_head_dim"]
    bs, s, _ = x.shape
    proj = mm(x, w[p + "in_proj"])
    z, xbc, dt = proj.split([di, di + 2 * ns, nh], dim=-1)
    k = m["conv_width"]
    xbc = F.conv1d(xbc.transpose(1, 2), w[p + "conv_w"].t()[:, None, :],
                   w[p + "conv_b"], padding=k - 1, groups=xbc.shape[-1])
    xbc = F.silu(xbc[..., :s].transpose(1, 2))
    xs, bm, cm = xbc.split([di, ns, ns], dim=-1)
    dt = F.softplus(dt + w[p + "dt_bias"])                  # (B, S, H)
    a = -torch.exp(w[p + "a_log"])
    xs = xs.reshape(bs, s, nh, hd)
    y = ssd(xs * dt[..., None], dt * a, bm, cm, block)
    y = (y + w[p + "d_skip"][:, None] * xs).reshape(bs, s, di)
    y = rmsnorm(y * F.silu(z), w[p + "norm"], m["norm_eps"])
    return mm(y, w[p + "out_proj"])


def forward(w, m: dict, tokens: torch.Tensor, mm=matmul,
            block: int = 256) -> torch.Tensor:
    """Logits (B, S, vocab), float32, of float32 weights ``w``."""
    h = w["embed.tok"][tokens.long()]
    for i in range(m["n_layers"]):
        x = rmsnorm(h, w[f"blocks.{i}.norm1.scale"], m["norm_eps"])
        h = h + mixer(w, i, m, x, mm, block)
    h = rmsnorm(h, w["final_norm.scale"], m["norm_eps"])
    return mm(h, w["embed.tok"].t())


def loss_and_grads(w, m: dict, tokens, targets, mm=matmul, rows: int = 1):
    """The mean next-token cross-entropy over every position of the batch
    and its gradients, ``rows`` batch rows at a time (each layer
    recomputed in the backward, so that it fits)."""
    from torch.utils.checkpoint import checkpoint
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    total, n = 0.0, tokens.numel()
    for lo in range(0, tokens.shape[0], rows):
        tk, tg = tokens[lo:lo + rows], targets[lo:lo + rows]
        h = leaves["embed.tok"][tk.long()]
        for i in range(m["n_layers"]):
            def block_fn(h, i=i):
                x = rmsnorm(h, leaves[f"blocks.{i}.norm1.scale"],
                            m["norm_eps"])
                return h + mixer(leaves, i, m, x, mm, 256)
            h = checkpoint(block_fn, h, use_reentrant=False)
        h = rmsnorm(h, leaves["final_norm.scale"], m["norm_eps"])
        logits = mm(h, leaves["embed.tok"].t())
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              tg.reshape(-1).long(), reduction="sum")
        part = nll / n
        g = torch.autograd.grad(part, list(leaves.values()))
        for k, gi in zip(leaves, g):
            grads[k] += gi
        total += float(part.detach())
        del logits, nll, part, g, h
    return total, grads


def adamw_lr(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then cosine decay to
    0 at ``total_steps`` (step counted from 1)."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * 0.5 * (1 + math.cos(math.pi * frac))


def train(w0: Dict[str, torch.Tensor], m: dict, opt: dict, batches,
          mm=matmul, rows: int = 1):
    """``len(batches)`` AdamW steps from ``w0`` (float32 copies).  Each
    gradient is clipped to a global norm of ``clip_norm``; the moments
    start at 0; the update is ``(m / bc1) / (sqrt(v / bc2) + eps) + wd p``
    times the step's learning rate.  Returns (losses, the first step's
    clipped gradient norm per leaf, the final weights)."""
    w = {k: v.float().clone() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses: List[float] = []
    first_norms = None
    b1, b2 = opt["b1"], opt["b2"]
    for t, (tokens, targets) in enumerate(batches, start=1):
        loss, g = loss_and_grads(w, m, tokens, targets, mm, rows)
        losses.append(loss)
        norm = torch.sqrt(sum(x.double().square().sum() for x in g.values()))
        clip = min(1.0, opt["clip_norm"] / max(float(norm), 1e-9))
        lr = adamw_lr(opt, t)
        with torch.no_grad():
            for k in w:
                gk = g[k] * clip
                mu[k].mul_(b1).add_(gk * (1 - b1))
                nu[k].mul_(b2).add_(gk.square() * (1 - b2))
                upd = (mu[k] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** t)) + opt["eps"]) \
                    + opt["weight_decay"] * w[k]
                w[k].sub_(lr * upd)
        if first_norms is None:
            first_norms = {k: float(torch.linalg.vector_norm(g[k] * clip))
                           for k in g}
        del g
    return losses, first_norms, w


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], skip=(),
              at: float = 1.0) -> float:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of its median leaf; the worst leaf's
    (``at`` 1) or the median leaf's (``at`` 0.5) gap."""
    med = float(np.median([ref[k] for k in ref]))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med)
            for k in ref if k not in skip]
    return max(gaps) if at == 1.0 else float(np.quantile(gaps, at))
