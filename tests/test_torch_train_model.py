"""The PyTorch port's training path against the JAX package, on the CPU:
``Model.loss_fn`` and every parameter's gradient, an N-step
``Trainer.fit`` history, K4's backward (``flash_attention_bwd``'s plain
version and the autograd path through ``flash_attention``) and the
training command line.  The JAX weights are carried across by
``convert.params_from_numpy``; batches are drawn with numpy.

Tolerances, float32:
* loss and metrics 1e-5 relative; gradients 1e-5 absolute plus 1e-4
  relative (the same function, differentiated by two frameworks; the JAX
  model runs blockwise online-softmax attention, the port the
  materialized softmax, so sums run in other orders).
* trainer histories: losses 1e-5 relative, gradient norms 1e-4 relative,
  parameters after five AdamW steps 1e-4 absolute (a fiftieth of one
  step of lr 5e-3: AdamW divides by sqrt(v), so where an element's
  gradient is small, the frameworks' last-bit differences in it move its
  update by more than they move the gradient).
* K4's plain backward against ``torch.autograd`` of the plain forward and
  against ``jax.grad`` of the JAX ``flash_attention_ref``: 1e-5; under
  ``gradcheck`` in float64, at tiny sizes, at its default tolerances.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jfa_ref)
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pair(arch, seed=0, **over):
    jc = dataclasses.replace(jconfigs.get_smoke_config(arch),
                             dtype="float32", **over)
    tc = dataclasses.replace(tconfigs.get_smoke_config(arch),
                             dtype="float32", **over)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jm.init(jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jc, tc, jm, tm, jp, convert.params_from_numpy(tc, tree,
                                                         device="cpu")


def _batch(cfg, seed, batch=2, seq=20, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (batch, seq))
         .astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((batch, seq)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.tensor(v) for k, v in b.items()})


# --------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch,remat,mask", [
    ("gemma3-1b", "none", False), ("gemma3-1b", "dots", True),
    ("qwen3-1.7b", "full", False), ("qwen3-1.7b", "dots", True)])
def test_loss_and_every_gradient_vs_jax(arch, remat, mask):
    """gemma3-1b smoke (prompt 20 > window 16: local layers mask) and
    qwen3-1.7b smoke (qk_norm, GQA 4/2); remat changes no value."""
    jc, tc, jm, tm, jp, tp = _pair(arch, seed=3, remat=remat)
    jb, tb = _batch(jc, 5, mask=mask)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jb)
    leaves = T.leaves(tp.tree())
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tm.loss_fn(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for k in ("ce", "aux", "ppl_proxy"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5,
                                              abs=1e-7), k
    want = T.leaves(convert.port_layout(tc, jax.tree.map(np.asarray, jg)))
    names = [n for n, _ in T.flatten_with_names(tp.tree())]
    assert len(want) == len(grads) == len(names)
    for name, g, w in zip(names, grads, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), w, atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    assert max(float(np.abs(w).max()) for w in want) > 1e-2


def test_loss_takes_int32_targets_and_remat_keeps_values():
    """SpinIngest hands out int32 tokens; the port's three remat settings
    give the same loss and gradients."""
    _, tc, _, tm, _, tp = _pair("gemma3-1b", seed=4)
    _, tb = _batch(tc, 6)
    assert tb["targets"].dtype == torch.int32
    out = []
    for remat in ("none", "dots", "full"):
        tm.cfg = dataclasses.replace(tc, remat=remat)
        leaves = T.leaves(tp.tree())
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = tm.loss_fn(tp, tb)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for a, b in zip(grads, out[0][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- trainer
# (arch, microbatches); the gemma3-1b cases keep their earlier ids
HISTORY_CASES = [
    pytest.param("gemma3-1b", 1, id="1"),
    pytest.param("gemma3-1b", 2, id="2"),
    *(pytest.param(arch, micro, id=f"{arch}-{micro}")
      for arch in ("whisper-tiny", "qwen2-vl-2b", "mamba2-780m")
      for micro in (1, 2)),
]


def _history_batches(jc, tc, n, batch=4, seq=20):
    """``n`` float32 training batches as numpy dicts: gemma3-1b's from the
    corpus, as the launcher feeds them; the other families' from
    ``shapes.train_batch_specs`` of both packages (equal arrays), whisper
    with ragged ``enc_len`` and qwen2-vl with its three M-RoPE components
    drawn apart (tests/test_torch_vlm.py), so that a microbatch that takes
    the wrong rows of ``enc_len`` or ``positions`` shows."""
    if jc.family == "dense":
        corpus = jdata.SyntheticCorpus(jc.vocab, seed=2)
        toks = [corpus.batch(i, batch, seq) for i in range(n)]
        return [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in toks]
    from test_torch_encdec import batch_arrays
    from test_torch_vlm import _distinct_positions
    out = []
    for i in range(n):
        nb = batch_arrays(jc, tc, seq, batch, seed=20 + i, train=True)
        if jc.family == "encdec":
            # ragged as chip_smoke.py's RAGGED_ENC_LEN (all, four fifths,
            # seven fifteenths), but no row of one key: its cross-attention
            # key gradient is 0 in exact arithmetic, so in float32 it is
            # rounding noise alone, which AdamW scales up to whole steps on
            # the small xattn/wk gradients (with 1 here, one element read
            # 3.0e-4 after five steps); K4b's card tests hold that row to 0
            e = jc.enc_seq
            nb["enc_len"] = np.array([e, e * 4 // 5, e * 7 // 15, e // 3],
                                     np.int32)
        elif jc.family == "vlm":
            nb["positions"] = _distinct_positions(batch, seq, seed=i)
        out.append(nb)
    return out


@pytest.mark.parametrize("arch,micro", HISTORY_CASES)
def test_trainer_history_vs_jax(arch, micro):
    """Five ``Trainer.fit`` steps from the same params on the same batches:
    the same history (loss, grad norm at every step) and parameters, for
    every family that trains on one card, with 1 and 2 microbatches (2
    splits ``positions`` (3, B, S) on dim 1, as the JAX trainer does)."""
    jc, tc, jm, tm, jp, tp = _pair(arch, seed=5)
    batches = _history_batches(jc, tc, 5)
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=50)
    jtr = JTrainer(jm, jopt.OptConfig(**ocfg), JTrainerConfig(
        steps=5, microbatches=micro, log_every=1, donate=False))
    jp, js, jh = jtr.fit(jp, jopt.init(jp), (
        {k: jnp.asarray(v) for k, v in b.items()} for b in batches),
        resume=False)
    tr = Trainer(tm, opt.OptConfig(**ocfg), TrainerConfig(
        steps=5, microbatches=micro, log_every=1))
    tp, ts, th = tr.fit(tp, opt.init(tp.tree()), (
        {k: torch.tensor(v) for k, v in b.items()} for b in batches),
        resume=False)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == \
        [1, 2, 3, 4, 5]
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    want = T.leaves(convert.port_layout(tc, jax.tree.map(np.asarray, jp)))
    got = T.leaves(tp.tree())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), b, atol=1e-4, rtol=0)
    for a, b in zip(T.leaves((ts.mu, ts.nu)),
                    T.leaves((convert.port_layout(tc, jax.tree.map(
                        np.asarray, js.mu)), convert.port_layout(
                            tc, jax.tree.map(np.asarray, js.nu))))):
        np.testing.assert_allclose(_np(a), b, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-2b"])
def test_train_cli_cannot_feed_encdec_or_vlm(arch, tmp_path):
    """A reference quirk, pinned on both sides: the JAX package's training
    launcher and the port's feed only ``tokens`` and ``targets``, so on
    the encdec and vlm families both fail with the same ``KeyError`` (the
    first input the model reads that the launcher does not feed); these
    families train through ``Trainer`` with ``shapes`` batches."""
    from repro.launch import train as jlaunch
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--ckpt-every", "0", "--max-restarts", "0"]
    errs = []
    for main, extra in ((jlaunch.main, []), (tlaunch.main,
                                             ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--ckpt-dir", str(tmp_path / str(len(errs)))]
                 + extra)
        # the JAX error also carries a note on its filtered traceback
        errs.append(re.findall(r"KeyError: '(\w+)'", str(exc.value)))
    missing = "enc_frames" if arch == "whisper-tiny" else "img_embeds"
    assert errs == [[missing], [missing]]


def test_microbatches_accumulate_in_float32():
    """bfloat16 parameters, 2 microbatches: the step's gradients are the
    float32 mean of the two microbatches' bfloat16 gradients (not a sum
    rounded to bfloat16 on the way)."""
    tc = dataclasses.replace(tconfigs.get_smoke_config("qwen3-1.7b"),
                             dtype="bfloat16")
    tm = tbuild(tc)
    tp = tm.init(torch.Generator().manual_seed(0))
    _, tb = _batch(tc, 7, batch=4)
    leaves = T.leaves(tp.tree())
    for p in leaves:
        p.requires_grad_(True)
    halves = []
    for i in range(2):
        loss, _ = tm.loss_fn(tp, {k: v[2 * i:2 * i + 2]
                                  for k, v in tb.items()})
        halves.append(torch.autograd.grad(loss, leaves))
    want = [(a.float() + b.float()) / 2 for a, b in zip(*halves)]
    seen = {}
    orig = opt.apply_updates

    def spy(params, ost, grads, cfg):
        seen["grads"] = grads
        return orig(params, ost, grads, cfg)
    opt.apply_updates = spy
    try:
        tr = Trainer(tm, opt.OptConfig(), TrainerConfig(microbatches=2))
        tr.build_step()(tp, opt.init(tp.tree()), tb)
    finally:
        opt.apply_updates = orig
    for g, w in zip(seen["grads"], want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


# ------------------------------------------------------- K4's backward
CASES = [  # B, Sq, Sk, H, KV, D, causal, window
    (2, 13, 13, 4, 2, 8, True, 0),       # causal, GQA
    (1, 17, 17, 2, 1, 8, True, 5),       # window
    (2, 9, 12, 2, 2, 8, False, 0),       # not causal, Sq != Sk
    (1, 12, 12, 4, 1, 8, False, 3),      # not causal, window
]


def _qkvo(case, dtype, seed):
    b, sq, sk, h, kv, d, causal, window = case
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d))]
    return arrs, [torch.tensor(a, dtype=dtype) for a in arrs]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_vs_autograd_and_jax(case):
    b, sq, sk, h, kv, d, causal, window = case
    (q, k, v, do), (tq, tk, tv, tdo) = _qkvo(case, torch.float32, 1)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    out = fa_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window)
    auto = torch.autograd.grad(out, (tq, tk, tv), tdo)
    got = fa_ops.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                     out.detach(), tdo, causal=causal,
                                     window=window)
    # the JAX oracle in its own layout, (H, S, D) per batch row, K/V
    # repeated across each group; its gradients summed back over the group
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
    for mine, a, j in zip(got, auto, jgrads):
        np.testing.assert_allclose(_np(mine), _np(a), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(mine), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


# gradcheck's numerical Jacobian runs the forward twice per input element,
# so its cases are tinier than CASES: causal with GQA, window, not causal
# with Sq != Sk, not causal with a window
GRADCHECK_CASES = [(1, 7, 7, 4, 2, 4, True, 0), (1, 9, 9, 2, 1, 4, True, 3),
                   (1, 5, 7, 2, 2, 4, False, 0), (1, 6, 6, 2, 1, 4, False, 2)]


@pytest.mark.parametrize("case", GRADCHECK_CASES)
def test_flash_attention_gradcheck_float64(case):
    """The autograd path of ``flash_attention`` (the forward's plain version,
    then ``flash_attention_bwd``'s) under gradcheck.  One intra-op thread:
    hundreds of tiny float64 forwards run faster without a thread pool,
    most of all beside other test workers."""
    b, sq, sk, h, kv, d, causal, window = case
    _, (q, k, v, _) = _qkvo(case, torch.float64, 2)
    for t in (q, k, v):
        t.requires_grad_(True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(
            lambda q, k, v: fa_ops.flash_attention(
                q, k, v, causal=causal, window=window), (q, k, v))
    finally:
        torch.set_num_threads(threads)


def test_flash_attention_grad_path_on_cpu_takes_plain_versions():
    """Through ``flash_attention`` with autograd on, the CPU backward is the
    plain one, fed the lse that the forward saved, and no kernel launch is
    counted."""
    case = CASES[0]
    _, (q, k, v, do) = _qkvo(case, torch.float32, 3)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    out = fa_ops.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    _, lse = fa_ref.flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                        causal=True, return_lse=True)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out, do, causal=True,
                                          lse=lse)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (fa_ops.launches, fa_ops.bwd_launches) == before


# -------------------------------------------------------- command line
@pytest.mark.parametrize("spin", [False, True])
def test_train_cli_smoke_on_cpu(spin, tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)]
    if spin:
        cmd.append("--spin-ingest")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [line.split() for line in r.stdout.splitlines()
            if line.strip().startswith("step")]
    assert all(np.isfinite([float(row[-1]) for row in rows]))
    # as the JAX launcher: the spin-ingest loop takes its first batch
    # before the loop, so 4 feeds train 3 steps (all logged); the plain
    # loop trains 4 and prints the last 3 logged
    assert [int(row[1]) for row in rows] == ([1, 2, 3] if spin
                                             else [2, 3, 4])
    assert ("overlap ratio R =" in r.stdout) == spin
    assert "done (restarts=0)" in r.stdout


def test_train_cli_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--smoke", "--steps", "2"])
