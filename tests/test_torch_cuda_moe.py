"""The grouped expert kernel K6 (``kernels/moe_experts``) and the dropless
MoE path on an NVIDIA GPU: K6 against its plain version at ragged row
counts (an expert with every row, experts with none, 16 and 32,768
rows), bit for bit across two runs, its planted faults caught; the
dropless ``moe_apply`` with no host synchronisation and against the CPU;
the serving path's K6 launches, one call a layer in a prefill and in a
decode step; and the engine's decode graph against its eager steps.

Tolerance: the row error (each row's largest error over that row's RMS)
0.1, K4's and K5's in bfloat16.  Both versions accumulate in float32 and
round the SwiGLU and the output to bfloat16 once, but in another order
and with another exp, so a rounding can fall the other way: a unit in
the last place of the largest outputs.

Every test here is marked ``cuda`` and skips where torch.cuda is not
available; this file imports nothing of JAX:
PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import row_error  # noqa: E402
from repro_torch.kernels.moe_experts import ops as k6_ops  # noqa: E402
from repro_torch.kernels.moe_experts.ref import moe_experts_ref  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda
ROW_TOL = 0.1
D, FF, E, E_PAD = 2048, 1408, 60, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda")


def _weights(dev, d=D, ff=FF, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = [torch.randn((E_PAD, d, ff), generator=g, device=dev) / d ** 0.5,
         torch.randn((E_PAD, d, ff), generator=g, device=dev) / d ** 0.5,
         torch.randn((E_PAD, ff, d), generator=g, device=dev) / ff ** 0.5]
    w = [t.to(torch.bfloat16) for t in w]
    for t in w:
        t[E:] = 0
    return w


def _rows(case, dev, d=D):
    """(x sorted rows, offsets (E_PAD + 1,)) of one case."""
    g = torch.Generator(device=dev).manual_seed(1)
    if case in ("decode16", "prefill32768", "ragged"):
        tokens = {"decode16": 4, "prefill32768": 8192, "ragged": 97}[case]
        logits = torch.randn((tokens, E), generator=g, device=dev)
        logits[:, 5] -= 100                     # an expert with no rows
        top = torch.topk(logits, 4, dim=-1).indices.reshape(-1)
        counts = torch.bincount(top, minlength=E_PAD)
    elif case == "one_expert_every_row":
        counts = torch.zeros(E_PAD, dtype=torch.int64, device=dev)
        counts[7] = 300
    else:                                        # skewed: most rows to one
        counts = torch.zeros(E_PAD, dtype=torch.int64, device=dev)
        counts[0], counts[3], counts[E - 1] = 1000, 17, 1
    off = torch.zeros(E_PAD + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(counts, 0)
    x = torch.randn((int(off[-1]), d), generator=g, device=dev)
    return x.to(torch.bfloat16), off


CASES = ["decode16", "prefill32768", "ragged", "one_expert_every_row",
         "skewed"]


@pytest.mark.parametrize("case", CASES)
def test_moe_experts_kernel_vs_plain(cuda, case):
    w = _weights(cuda)
    x, off = _rows(case, cuda)
    want = moe_experts_ref(x, off, *w)
    before = k6_ops.launches
    got = k6_ops.moe_experts(x, off, *w)
    again = k6_ops.moe_experts(x, off, *w)
    torch.cuda.synchronize()
    assert k6_ops.launches - before == 4
    assert row_error(got, want) <= ROW_TOL
    assert torch.equal(got, again)               # bit-stable


@pytest.mark.parametrize("cfg", [0, 1, 2])
def test_moe_experts_each_tile_configuration_vs_plain(cuda, cfg):
    # every tile size at a ragged row count and at widths that are no
    # multiple of its tiles (the K and N tails zero-filled)
    for d, ff in ((D, FF), (72, 40)):
        w = _weights(cuda, d=d, ff=ff)
        x, off = _rows("ragged", cuda, d=d)
        want = moe_experts_ref(x, off, *w)
        got = k6_ops._launch(x, off, *w, torch.zeros(
            1, dtype=torch.int32, device=cuda), 0, cfg)
        assert row_error(got, want) <= ROW_TOL


@pytest.mark.parametrize("fault", [1, 2, 3])
@pytest.mark.parametrize("case", ["decode16", "ragged"])
def test_moe_experts_planted_faults_fail(cuda, case, fault):
    w = _weights(cuda)
    x, off = _rows(case, cuda)
    want = moe_experts_ref(x, off, *w)
    got = k6_ops.moe_experts_planted(x, off, *w, fault=fault)
    assert row_error(got, want) > ROW_TOL


def test_moe_experts_counts_the_experts_with_rows(cuda):
    w = _weights(cuda)
    x, off = _rows("ragged", cuda)
    k6_ops.reset_active(cuda)
    k6_ops.moe_experts(x, off, *w)
    k6_ops.moe_experts(x, off, *w)
    assert k6_ops.active_experts(cuda) == 2 * int(
        (off[1:] > off[:-1]).sum())


def test_moe_experts_raises_where_it_has_no_path(cuda):
    w = _weights(cuda, d=64, ff=32)
    x, off = _rows("ragged", cuda, d=64)
    with pytest.raises(ValueError, match="dtype"):
        k6_ops.moe_experts(x.float(), off, *[t.float() for t in w])
    with pytest.raises(NotImplementedError, match="backward"):
        k6_ops.moe_experts(x.requires_grad_(), off, *w)


def _dropless_cfg(**kw):
    base = configs.get_smoke_config("qwen2-moe-a2.7b")
    return dataclasses.replace(
        base, n_experts=60, top_k=4, n_shared_experts=1, d_ff_shared=64,
        moe_dropless=True, moe_norm_topk=False, moe_shared_gate=True,
        dtype="bfloat16", **kw)


def _on_cpu(p):
    return {k: _on_cpu(v) if isinstance(v, torch.nn.ParameterDict)
            else v.detach().cpu() for k, v in p.items()}


def test_dropless_moe_apply_reads_nothing_on_the_host(cuda):
    cfg = _dropless_cfg()
    g = torch.Generator(device=cuda).manual_seed(0)
    p = M.moe_init(g, cfg)
    x = torch.randn((4, 33, cfg.d_model), generator=g, device=cuda
                    ).to(torch.bfloat16)
    with torch.inference_mode():
        M.moe_apply(p, cfg, x, with_aux=False)       # built and warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = M.moe_apply(p, cfg, x, with_aux=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # the CPU's plain loop on the same weights
        want, _ = M.moe_apply(_on_cpu(p), cfg, x.cpu(), with_aux=False)
    assert row_error(y.cpu(), want) <= ROW_TOL


def test_serving_path_launches_k6_per_layer(cuda):
    cfg = _dropless_cfg(d_model=256, n_heads=2, n_kv_heads=2, head_dim=128,
                        vocab=512, n_layers=3)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    engine = ServeEngine(model, params, max_len=80)
    tokens = torch.randint(0, cfg.vocab, (4, 64), device=cuda)
    k6, k4 = k6_ops.launches, fa_ops.launches
    st = engine.prefill({"tokens": tokens})
    torch.cuda.synchronize()
    assert (k6_ops.launches - k6, fa_ops.launches - k4) == (
        2 * cfg.n_layers, cfg.n_layers)
    k6 = k6_ops.launches
    for _ in range(3):
        _, st = engine.step(st)
    torch.cuda.synchronize()
    assert k6_ops.launches - k6 == 3 * 2 * cfg.n_layers


def test_decode_graph_replays_the_eager_steps(cuda):
    cfg = _dropless_cfg(d_model=256, n_heads=2, n_kv_heads=2, head_dim=128,
                        vocab=512, n_layers=3)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    eager = ServeEngine(model, params, max_len=80)
    graph = ServeEngine(model, params, max_len=80, cuda_graph=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    # the second request's cache is copied into the graph's over the first
    for _ in range(2):
        tokens = torch.randint(0, cfg.vocab, (4, 64), device=cuda,
                               generator=g)
        runs = []
        for eng in (eager, graph):
            st = eng.prefill({"tokens": tokens})
            toks, logits = [], []
            for _ in range(6):
                nxt, st = eng.step(st)
                toks.append(nxt)
                logits.append(st.logits)
            runs.append((torch.cat(toks, 1), torch.stack(logits, 1)))
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
    assert list(graph._graphs) == [4]
    torch.cuda.synchronize()
    k6 = k6_ops.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, st = graph.step(st)                   # no host read, no launch
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert k6_ops.launches == k6
    # a request whose cache the graph's has since taken over
    a = graph.prefill({"tokens": tokens})
    _, a = graph.step(a)
    b = graph.prefill({"tokens": tokens})
    _, b = graph.step(b)
    with pytest.raises(ValueError, match="taken"):
        graph.step(a)
