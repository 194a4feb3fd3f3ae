"""The PyTorch port's dry run (``launch/{dryrun,roofline,report}``) against
the JAX package's, on the CPU.

* State bytes a device, ``tokens`` and ``kind`` of all 66 supported cells
  (33 on ``pod``, 33 on ``multipod``): the JAX side runs ``build_cell`` and
  ``analytic_bytes_per_device`` (no lowering, no compile) in one
  subprocess with 512 fake host devices; the port's ``build_cell`` and
  ``state_bytes_per_device`` run on a fake world of 256 or 512 ranks in
  one subprocess per mesh, without tracing a step.  Equal to rel 1e-12.
  The manual-DP state (parameters, moments, error rows) of gemma3-1b's
  ``train_4k`` on ``pod``, and the pure-DP layout's of gemma3-1b and
  qwen2-moe-a2.7b, likewise.
* Traced cells, each through ``python -m repro_torch.launch.dryrun`` in
  its own subprocess: an ``ok`` row with nonzero FLOPs, bytes accessed
  and collective bytes, the state bytes of the JAX package, K4 and K4b
  counted as often as the step calls them.
* The counting mode: a DTensor product counts only the rank's local
  FLOPs (once, not again at the global shapes DTensor infers with); the
  collectives of a redistribution and of ``torch.distributed`` are seen.
* K4's and K4b's FLOP formulas (``live_pairs``) against a brute-force
  mask count at small shapes (causal, window, ``kv_len``), and through
  the custom ops under ``FakeTensorMode``.
* ``derive``, ``model_flops``, ``to_markdown_table``, ``recompute`` and
  ``report.markdown`` against the JAX package's on the same rows; the
  terms compared after scaling by the ratio of the two packages' card
  constants (H100 against the JAX package's), exactly up to float
  rounding (rel 1e-12).
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jrf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import report as trep  # noqa: E402
from repro_torch.launch import roofline as trf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600
CELLS = [f"{a}/{s}/{m}" for m in ("pod", "multipod")
         for a in tconfigs.ARCHS for s in tshapes.SHAPES
         if tshapes.cell_supported(a, s)[0]]
TRACED = [  # (arch, shape, mesh, extra flags, K4 calls, K4b calls)
    ("gemma3-1b", "train_4k", "pod", [], 52, 26),
    ("qwen2-vl-2b", "prefill_32k", "pod", [], 28, 0),
    ("gemma3-1b", "decode_32k", "multipod", [], 0, 0),
    ("recurrentgemma-9b", "long_500k", "pod", [], 0, 0),
    ("qwen2-moe-a2.7b", "decode_32k", "multipod", [], 0, 0),
    ("gemma3-1b", "train_4k", "pod", ["--manual-dp-int8", "--variant",
                                      "mdp"], 52, 26),
]
TRACED_IDS = [f"{a}-{s}-{m}{'-mdp' if x else ''}"
              for a, s, m, x, _, _ in TRACED]


def _env(devices=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def _run(args, devices=None):
    r = subprocess.run([sys.executable, *map(str, args)], env=_env(devices),
                       capture_output=True, text=True, timeout=TIMEOUT,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r


JAX_CELLS = r"""
import json, sys
from repro import configs
from repro.configs import shapes as shp
from repro.launch import dryrun as dr
from repro.launch import report as rep
from repro.launch.mesh import make_production_mesh

out = {}
for mesh_name in ("pod", "multipod"):
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    for arch in configs.ARCHS:
        for shape in shp.SHAPES:
            if not shp.cell_supported(arch, shape)[0]:
                continue
            fn, args, state, tokens, cfg, model, kind = dr.build_cell(
                arch, shape, mesh, arch in dr.FSDP_ARCHS)
            out[f"{arch}/{shape}/{mesh_name}"] = [
                sum(dr.analytic_bytes_per_device(t, s, mesh)
                    for t, s in state), tokens, kind]
mesh = make_production_mesh()
for key, arch, kw in (("mdp", "gemma3-1b", {"manual_dp": True}),
                      ("puredp/gemma3-1b", "gemma3-1b", {"pure_dp": True}),
                      ("puredp/qwen2-moe-a2.7b", "qwen2-moe-a2.7b",
                       {"pure_dp": True})):
    fn, args, state, tokens, cfg, model, kind = dr.build_cell(
        arch, "train_4k", mesh, False, **kw)
    out[key] = [sum(dr.analytic_bytes_per_device(t, s, mesh)
                    for t, s in state), tokens, kind]
with open(sys.argv[2]) as f:
    rows = json.load(f)
out["markdown"] = rep.markdown(rows)
out["recomputed"] = [rep.recompute(r).get("roofline") for r in rows]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""

PORT_CELLS = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.configs import shapes as shp
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh

mesh_name, path = sys.argv[1], sys.argv[2]
multi = mesh_name == "multipod"
out = {}
with dr.fake_world(512 if multi else 256):
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    cells = [(f"{a}/{s}/{mesh_name}", a, s, {}) for a in configs.ARCHS
             for s in shp.SHAPES if shp.cell_supported(a, s)[0]]
    if not multi:
        cells += [("mdp", "gemma3-1b", "train_4k", {"manual_dp": True})]
        cells += [(f"puredp/{a}", a, "train_4k", {"pure_dp": True})
                  for a in ("gemma3-1b", "qwen2-moe-a2.7b")]
    for key, arch, shape, kw in cells:
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, state, tokens, cfg, model, kind = dr.build_cell(
                arch, shape, mesh, arch in dr.FSDP_ARCHS and not kw, **kw)
            out[key] = [dr.state_bytes_per_device(*state), tokens, kind]
    if not multi:        # the counting mode on a DTensor product
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch.roofline import CountingMode
        from repro_torch.parallel import dtensor as D
        import torch.distributed as dist
        with FakeTensorMode():
            a = D.zeros_placed((256, 4096), torch.bfloat16, mesh,
                               [Shard(0), Replicate()], "cpu")
            w = D.zeros_placed((4096, 4096), torch.bfloat16, mesh,
                               [Replicate(), Shard(1)], "cpu")
            counts = []
            for _ in range(2):       # the first meets DTensor's inference
                with CountingMode() as m:
                    y = a @ w
                counts.append([m.flops, m.bytes, m.collectives["total"]])
            with CountingMode() as m:
                D.whole(y)
            counts.append(dict(m.collectives))
            t = torch.zeros(1000)
            with CountingMode() as m:
                dist.all_reduce(t)
            counts.append(dict(m.collectives))
        out["dtensor"] = counts
with open(path, "w") as f:
    json.dump(out, f)
"""


def _jax_rows(rows):
    """The port's rows in the JAX package's row keys (the same numbers)."""
    out = []
    for r in rows:
        j = dict(r)
        j["compile_s"] = j.pop("trace_s")
        j["fits_v5e_hbm_16g"] = j.pop("fits_h100_hbm_80g")
        out.append(j)
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each traced cell's row, three subprocesses at a time."""
    out = tmp_path_factory.mktemp("dryrun")

    def one(cell):
        arch, shape, mesh, extra, _, _ = cell
        _run(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
              shape, "--mesh", mesh, "--out", out, *extra])
        name = f"{arch}__{shape}__{mesh}" + ("__mdp" if extra else "")
        with open(out / f"{name}.json") as f:
            return json.load(f)
    with ThreadPoolExecutor(3) as ex:
        rows = list(ex.map(one, TRACED))
    return out, rows


@pytest.fixture(scope="module")
def cells(tmp_path_factory, traced):
    """(JAX's results, the port's): the 66 cells' state bytes, tokens and
    kinds, the manual-DP state, the counting-mode probes, and JAX's
    report of the traced rows."""
    out = tmp_path_factory.mktemp("cells")
    _, rows = traced
    with open(out / "rows.json", "w") as f:
        json.dump(_jax_rows(rows), f)
    jobs = [(["-c", JAX_CELLS, out / "jax.json", out / "rows.json"], 512),
            (["-c", PORT_CELLS, "pod", out / "pod.json"], None),
            (["-c", PORT_CELLS, "multipod", out / "multipod.json"], None)]
    with ThreadPoolExecutor(3) as ex:
        list(ex.map(lambda j: _run(*j), jobs))
    port = {}
    for name in ("pod", "multipod"):
        with open(out / f"{name}.json") as f:
            port.update(json.load(f))
    with open(out / "jax.json") as f:
        return json.load(f), port


@pytest.mark.parametrize("cell", CELLS)
def test_state_bytes_tokens_and_kind_equal_jax(cells, cell):
    jax_out, port = cells
    (jb, jt, jk), (tb, tt, tk) = jax_out[cell], port[cell]
    assert (tt, tk) == (jt, jk)
    assert tb == pytest.approx(jb, rel=1e-12, abs=0)


def test_cell_list_is_the_jax_packages(cells):
    jax_out, _ = cells
    assert len(CELLS) == 66
    assert sorted(CELLS) == sorted(k for k in jax_out if k.count("/") == 2
                                   and not k.startswith("puredp"))


@pytest.mark.parametrize("key", ["mdp", "puredp/gemma3-1b",
                                 "puredp/qwen2-moe-a2.7b"])
def test_manual_dp_and_pure_dp_state_bytes_equal_jax(cells, key):
    """``train_4k`` on ``pod`` with ``--manual-dp-int8`` (parameters,
    moments, error rows) and with ``--pure-dp`` (every leaf split over
    both axes where it divides; qwen2-moe's expert leaves are stacked in
    the JAX tree, the rule's leading dim)."""
    jax_out, port = cells
    assert port[key][0] == pytest.approx(jax_out[key][0], rel=1e-12)
    assert port[key][1:] == jax_out[key][1:]


def test_counting_mode_counts_a_dtensor_product_once_and_locally(cells):
    """(256, 4096) @ (4096, 4096) bf16 split (data, model) on (16, 16):
    the rank's (16, 4096) @ (4096, 256), twice alike (the first call meets
    DTensor's global-shape inference, which is not counted); its inputs
    and output read and written once; no collective.  Gathering the
    output is two all-gathers, one per mesh dim."""
    _, port = cells
    first, second, gather, allreduce = port["dtensor"]
    local = 2 * 16 * 4096 * 256
    assert first == second == [local, 2 * (16 * 4096 + 4096 * 256
                                           + 16 * 256), 0]
    assert gather["all-gather"] == gather["total"] == 2 * (
        256 * 256 + 256 * 4096) and gather["count"] == 2
    assert allreduce["all-reduce"] == 4000 and allreduce["count"] == 1


@pytest.mark.parametrize("cell", TRACED, ids=TRACED_IDS)
def test_traced_cell_row(traced, cells, cell):
    arch, shape, mesh, extra, k4, k4b = cell
    _, rows = traced
    jax_out, _ = cells
    row = rows[TRACED.index(cell)]
    assert row["status"] == "ok" and row["chips"] == (
        256 if mesh == "pod" else 512)
    assert row["probe"] is None and row["memory_analysis"] is None
    assert row["cost_analysis"]["flops"] > 0
    assert row["cost_analysis"]["bytes accessed"] > 0
    coll = row["collectives"]
    assert coll["total"] > 0 and coll["count"] > 0
    assert coll["total"] == sum(coll[k] for k in trf.COLLECTIVES)
    want = jax_out["mdp" if extra else f"{arch}/{shape}/{mesh}"]
    assert row["analytic_state_bytes_per_device"] == pytest.approx(
        want[0], rel=1e-12)
    assert row["fits_h100_hbm_80g"] == (want[0] < 80e9)
    assert row["kind"] == want[2]
    assert row["kernels"].get("repro::flash_attention", 0) == k4
    assert row["kernels"].get("repro::flash_attention_bwd", 0) == k4b
    t = row["roofline"]
    assert t["compute_s"] == row["cost_analysis"]["flops"] / trf.PEAK_FLOPS
    assert t["collective_s"] == coll["total"] / trf.LINK_BW
    if (arch, shape, extra) == ("gemma3-1b", "train_4k", []):
        assert row["trace_s"] < 60


def test_report_markdown_equals_jax(traced, cells):
    """The port's tables of the traced rows are the JAX package's, but
    for the two renamed columns."""
    _, rows = traced
    jax_out, _ = cells
    want = jax_out["markdown"].replace("compile s", "trace s").replace(
        "fits 16G", "fits 80G")
    assert trep.markdown(rows) == want


def test_recompute_equals_jax_scaled_by_the_constants(traced, cells):
    _, rows = traced
    jax_out, _ = cells
    for row, jt in zip(rows, jax_out["recomputed"]):
        t = trep.recompute(row)["roofline"]
        _same_terms(t, jt)
        assert t == row["roofline"]


def _same_terms(t, j):
    """Port terms ``t`` against JAX terms ``j`` of the same counts."""
    for k, pt, pj in (("compute_s", trf.PEAK_FLOPS, jrf.PEAK_FLOPS),
                      ("memory_s", trf.HBM_BW, jrf.HBM_BW),
                      ("collective_s", trf.LINK_BW, jrf.ICI_BW)):
        assert t[k] * pt == pytest.approx(j[k] * pj, rel=1e-12), k
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes", "model_flops",
              "useful_ratio", "bytes_per_device", "note", "chips"):
        assert t[k] == j[k], k
    terms = {n: t[f"{n}_s"] for n in ("compute", "memory", "collective")}
    assert t["bottleneck"] == max(terms, key=terms.get)


@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_derive_and_model_flops_equal_jax(arch):
    from repro import configs as jconfigs
    rng = np.random.default_rng(len(arch))
    for kind in ("train", "prefill", "decode"):
        tokens = int(rng.integers(1, 1 << 20))
        fwd = kind != "train"
        tc, jc = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert trf.model_flops(tc, tokens, fwd) == \
            jrf.model_flops(jc, tokens, fwd)
        f, b, c = (float(x) for x in rng.uniform(1e9, 1e15, 3))
        args = (arch, "train_4k", "pod", 256, f, b, c)
        t = trf.derive(*args, tc, tokens, bytes_per_device=1.5e9,
                       note="fsdp", fwd_only=fwd).row()
        j = jrf.derive(*args, jc, tokens, bytes_per_device=1.5e9,
                       note="fsdp", fwd_only=fwd).row()
        _same_terms(t, j)


def test_to_markdown_table_equals_jax(traced):
    _, rows = traced
    terms = [r["roofline"] for r in rows]
    assert trf.to_markdown_table(terms) == jrf.to_markdown_table(terms)


def test_constants_are_the_h100s():
    assert (trf.PEAK_FLOPS, trf.HBM_BW, trf.NVLINK_BW, trf.NIC_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert trf.LINK_BW == trf.NIC_BW


def test_cli_refuses_the_knobs_the_port_has_not(tmp_path):
    for flag, value in (("--block-q", "256"), ("--block-k", "256"),
                        ("--scores-dtype", "bfloat16")):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "gemma3-1b", "--shape", "train_4k", "--mesh", "pod", "--out",
             str(tmp_path), flag, value], env=_env(), capture_output=True,
            text=True, timeout=TIMEOUT, cwd=ROOT)
        assert r.returncode == 2 and "not a knob of the port" in r.stderr
    assert not list(tmp_path.iterdir())


def test_report_cli_reads_the_rows(traced, tmp_path):
    out, rows = traced
    r = _run(["-m", "repro_torch.launch.report", "--out", out,
              "--markdown", tmp_path / "report.md"])
    assert "wrote" in r.stdout
    text = (tmp_path / "report.md").read_text()
    plain = sum(1 for r in rows if not r["variant"])     # mdp: a variant
    assert f"OK: {plain}  skipped (documented): 0  failed: 0" in text
    assert "### Perf-iteration variants" in text
    assert "fits 80G" in text and "gemma3-1b | train_4k" in text


# ------------------------------------------------------ K4/K4b formulas
def _brute(sq, sk, causal, window, kv_len):
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    live = np.ones((sq, sk), bool)
    if causal:
        live &= j <= i
    if window > 0:
        live &= j > i - window
    if kv_len is not None:
        live &= j < kv_len
    return int(live.sum())


def test_live_pairs_against_a_brute_force_mask_count():
    rng = np.random.default_rng(0)
    cases = [(sq, sk, c, w, n)
             for sq in (1, 2, 7, 16, 33, 64) for sk in (1, 5, 16, 40, 64)
             for c in (False, True) for w in (0, 1, 3, 16, 100)
             for n in (None, 1, 4, 17, 64)]
    cases += [(int(rng.integers(1, 300)), int(rng.integers(1, 300)),
               bool(rng.integers(2)), int(rng.integers(0, 50)),
               int(rng.integers(1, 300))) for _ in range(300)]
    for sq, sk, c, w, n in cases:
        assert fa_ops.live_pairs(sq, sk, c, w, n) == \
            _brute(sq, sk, c, w, n), (sq, sk, c, w, n)


@pytest.mark.parametrize("causal,window,kv", [
    (True, 0, None), (True, 5, None), (False, 0, None), (False, 0, "ragged"),
    (False, 4, "ragged")])
def test_k4_and_k4b_flops_through_the_custom_ops(causal, window, kv):
    """Fake tensors take the custom ops (no library is loaded): the
    counting mode counts 4 D and 10 D FLOPs per live pair and head; a
    fake ``kv_len`` counts as Sk.  The formulas read a real ``kv_len``'s
    values from the one read ``_check_kv_len`` makes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, sq, sk, h, kvh, d = 3, 24, 40, 4, 2, 16
    lens = [40, 17, 1]
    pairs_sk = b * fa_ops.live_pairs(sq, sk, causal, window)
    with FakeTensorMode():
        q = torch.empty(b, sq, h, d, requires_grad=True)
        k = torch.empty(b, sk, kvh, d, requires_grad=True)
        v = torch.empty(b, sk, kvh, d, requires_grad=True)
        kv_len = (torch.empty(b, dtype=torch.int32) if kv else None)
        with trf.CountingMode() as m:
            out = fa_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, kv_len=kv_len)
            out.sum().backward()
    assert m.calls["repro::flash_attention"] == 1
    assert m.calls["repro::flash_attention_bwd"] == 1
    assert m.flops == 14 * d * h * pairs_sk
    real = torch.tensor(lens, dtype=torch.int64) if kv else None
    checked = fa_ops._check_kv_len(torch.empty(b, sq, h, d),
                                   torch.empty(b, sk, kvh, d), real)
    qs, ks = torch.empty(b, sq, h, d), torch.empty(b, sk, kvh, d)
    want = sum(fa_ops.live_pairs(sq, sk, causal, window, n)
               for n in (lens if kv else [None] * b))
    assert fa_ops._k4_flops(qs, ks, ks, checked, causal, window,
                            False) == 4 * d * h * want
    assert fa_ops._k4b_flops(qs, ks, ks, qs, qs, None, checked, causal,
                             window) == 10 * d * h * want


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-2b",
                                  "whisper-tiny"])
def test_a_fake_run_leaves_no_fake_constant_behind(arch):
    """The cached device constants (RoPE frequencies, M-RoPE components,
    whisper's sinusoids) are built outside ``FakeTensorMode``: with the
    caches empty, a fake forward first, then a real forward computes real
    logits, equal to those of a forward from empty caches."""
    import dataclasses as dc

    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model

    def clear():
        for fn in (L._rope_freqs_on, L._mrope_components, L.sinusoid_on):
            fn.cache_clear()
    cfg = dc.replace(tconfigs.get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in tshapes.train_batch_specs(
        cfg, 12, 2, np.random.default_rng(0)).items()}
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        clear()
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake, _ = model.forward(model.init(torch.Generator()), {
                k: torch.empty_like(v) for k, v in batch.items()})
        after, _ = model.forward(params, batch)
        clear()
        fresh, _ = model.forward(params, batch)
    assert isinstance(fake, FakeTensor)
    assert not isinstance(after, FakeTensor)
    assert torch.equal(after, fresh)

