"""K4's row log-sum-exp (lse), which its forward writes for K4b, on the
CPU: the port's plain lse (``flash_attention_ref(..., return_lse=True)``,
also what ``ops.flash_attention_with_lse`` returns for CPU tensors)
against ``jax.nn.logsumexp`` of the JAX reference's scaled, masked scores
(``src/repro/kernels/flash_attention/ref.py``); the plain backward fed
that lse against ``jax.grad`` of the JAX ``flash_attention_ref``; and the
autograd path, which saves lse and launches nothing on the CPU.

Tolerances, float32: 1e-5 absolute and relative (the same sums in other
orders).  A row with no live key has lse +inf in the port, the value K4
writes, for which exp(s - lse) is 0; the JAX reference's scores there are
all -1e30, so its logsumexp is about -1e30 and only the live rows are
compared with it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jfa_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from test_torch_train_model import CASES, _np, _qkvo  # noqa: E402

# B, Sq, Sk, H, KV, D, causal, window: not causal with a window of 3 and
# Sq > Sk + 2, so that rows 7 to 11 see no key
MASKED = (1, 12, 5, 2, 1, 8, False, 3)


def _jax_scores(q, k, causal, window):
    """The JAX reference's scaled, masked scores (B, H, Sq, Sk) and its
    mask (Sq, Sk), as ``ref.flash_attention_ref`` forms them, per batch row
    in its (H, S, D) layout with K repeated across each group."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qpos, kpos = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    out = []
    for bi in range(b):
        qh = jnp.transpose(q[bi], (1, 0, 2))
        kh = jnp.repeat(jnp.transpose(k[bi], (1, 0, 2)), h // kv, 0)
        s = jnp.einsum("hqd,htd->hqt", qh, kh) / np.sqrt(d)
        out.append(jnp.where(mask[None], s, -1e30))
    return jnp.stack(out), np.asarray(mask)


@pytest.mark.parametrize("case", CASES + [MASKED])
def test_plain_lse_vs_jax_logsumexp(case):
    causal, window = case[6:]
    (q, k, v, _), (tq, tk, tv, _) = _qkvo(case, torch.float32, 4)
    _, lse = fa_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                        window=window, return_lse=True)
    _, via_ops = fa_ops.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                                 window=window)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0],
                                                        q.shape[2],
                                                        q.shape[1])
    assert torch.equal(lse, via_ops)
    s, mask = _jax_scores(q, k, causal, window)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    live = mask.any(-1)
    got = lse.numpy()
    np.testing.assert_allclose(got[..., live], want[..., live], atol=1e-5,
                               rtol=1e-5)
    assert np.all(got[..., ~live] == np.inf)
    assert (case == MASKED) == (not live.all())


@pytest.mark.parametrize("case", CASES + [MASKED])
def test_plain_backward_from_lse_vs_jax(case):
    b, sq, sk, h, kv, d, causal, window = case
    (q, k, v, do), (tq, tk, tv, tdo) = _qkvo(case, torch.float32, 1)
    out, lse = fa_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                          window=window, return_lse=True)
    got = fa_ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, causal=causal,
                                         window=window, lse=lse)
    g = h // kv

    def jloss(q, k, v):
        tot = 0.0
        for bi in range(b):
            o = jfa_ref(jnp.transpose(q[bi], (1, 0, 2)),
                        jnp.repeat(jnp.transpose(k[bi], (1, 0, 2)), g, 0),
                        jnp.repeat(jnp.transpose(v[bi], (1, 0, 2)), g, 0),
                        causal=causal, window=window)
            tot = tot + jnp.sum(o * jnp.transpose(do[bi], (1, 0, 2)))
        return tot
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    for mine, j in zip(got, jgrads):
        assert np.isfinite(_np(mine)).all()
        np.testing.assert_allclose(_np(mine), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


def test_autograd_on_cpu_saves_lse_and_launches_nothing():
    """``flash_attention`` under autograd saves q, k, v, the output and lse;
    its CPU backward is the plain one fed that lse, and no K4 or K4b launch
    is counted."""
    case = MASKED
    causal, window = case[6:]
    _, (q, k, v, do) = _qkvo(case, torch.float32, 5)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    saved = out.grad_fn.saved_tensors
    _, lse = fa_ref.flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                        causal=causal, window=window,
                                        return_lse=True)
    assert len(saved) == 5 and torch.equal(saved[4], lse)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out, do, causal=causal,
                                          window=window, lse=lse)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (fa_ops.launches, fa_ops.bwd_launches) == before
