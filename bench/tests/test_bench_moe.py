"""The qwen2-moe serving cell's reference and driver on the CPU: the plain
float32 Qwen1.5-MoE-A2.7B (``bench/ref/qwen2_moe``) against the port's
prefill and decode through the cache at a small size, its leaves against
the port's at full width, its FLOP count against the port's products,
K6's bound, and the cell's rehearsal with each planted fault of the
published routing (not correct) and with the float8 control (beyond the
program)."""
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import program
from bench.ref import qwen2_moe as R

ROOT = Path(__file__).resolve().parents[2]
CELL = "serve.qwen2-moe-a2.7b.b4-p2048-g32"
CONFIG = json.loads((ROOT / "bench" / "configs" /
                     "qwen2-moe-a2.7b.json").read_text())


def _small(**kw):
    m = dict(CONFIG["model"], **CONFIG["smoke"]["model"])
    m.update(dtype="float32", **kw)
    return m


def _port(m, seed):
    from repro_torch.models.model import build_model
    model = build_model(program.model_config(m))
    params = model.init(torch.Generator().manual_seed(0))
    program.load_weights(params, R.make_weights(m, seed, "cpu"))
    return model, params


def test_reference_matches_the_ports_prefill_and_decode():
    m = _small()
    model, params = _port(m, 11)
    tokens = torch.randint(0, m["vocab"], (3, 15),
                           generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = R.forward(R.make_weights(m, 11, "cpu"), m, tokens, first=9)
        last, cache = model.prefill(params, {"tokens": tokens[:, :10]}, 15)
        got = [last]
        for pos in range(10, 15):
            logits, cache = model.decode_step(
                params, tokens[:, pos:pos + 1], cache, pos)
            got.append(logits)
    got = torch.stack(got[:-1], dim=1)
    assert torch.allclose(got, want[:, :5], atol=1e-4, rtol=1e-4)
    # not the same function without the published routing
    from repro_torch.models.model import build_model
    renorm = build_model(dataclasses.replace(model.cfg, moe_norm_topk=True))
    with torch.no_grad():
        other, _ = renorm.forward(params, {"tokens": tokens})
    assert not torch.allclose(other[:, 9:14], want[:, :5], atol=1e-2)


def test_weights_are_the_ports_leaves_at_full_width():
    from repro_torch.models.model import build_model
    m = CONFIG["model"]
    mine = dict(program.leaves(
        build_model(program.model_config(m)).init_eval().tree()))
    shp = R.shapes(m)
    assert set(shp) == set(mine)
    for k, p in mine.items():
        assert tuple(p.shape) == shp[k][0] and p.dtype == R.leaf_dtype(k, m)
    total = sum(torch.Size(s).numel() for s, _ in shp.values())
    assert 15.1e9 < total < 15.2e9              # 30.3 GB in bfloat16


def test_padded_experts_are_zero_and_weights_follow_the_seed():
    m = _small()
    w = R.make_weights(m, 3, "cpu")
    for leaf in ("gate", "up", "down"):
        t = w[f"blocks.0.moe.{leaf}"]
        assert t.shape[0] == 64 and not t[60:].any() and t[:60].abs().min(
            ) >= 0 and t[59].any()
    again = R.make_weights(m, 3, "cpu")
    other = R.make_weights(m, 4, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not torch.equal(w["blocks.1.attn.bq"], other["blocks.1.attn.bq"])


def test_flop_count_is_the_ports_decode_products():
    from torch.utils.flop_counter import FlopCounterMode
    m = _small()
    model, params = _port(m, 2)
    b, prompt = 2, 7
    tokens = torch.randint(0, m["vocab"], (b, prompt + 1),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tokens[:, :prompt]},
                                 prompt + 1)
        with FlopCounterMode(display=False) as fc:
            model.decode_step(params, tokens[:, prompt:], cache, prompt)
    assert fc.get_total_flops() == R.decode_flops(m, b, prompt)


def test_k6_bound_counts_active_weights_and_rows():
    m = CONFIG["model"]
    d, ff = 2048, 1408
    assert R.k6_bytes(m, 16, 14) == 14 * 3 * d * ff * 2 + 2 * 16 * d * 2
    assert R.k6_flops(m, 16) == 6 * 16 * d * ff
    # decode: bound by the weights; a large prefill: by the products
    assert R.k6_bound_s(m, 16, 14) == R.k6_bytes(m, 16, 14) / 3.35e12
    assert R.k6_bound_s(m, 32768, 60) == R.k6_flops(m, 32768) / 989e12


def _execute(plant=(), seed=2 ** 31 + 101):
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    spec = importlib.util.spec_from_file_location("bench_run_moe",
                                                  ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.execute(CELL, seed, 3.0, False, torch.device("cpu"),
                       time.perf_counter(), smoke=True, plant=plant)[0]


@pytest.mark.parametrize("fault", ["renormalised_topk", "shared_gate_off",
                                   "dropped_assignments"])
def test_a_planted_routing_fault_is_not_correct(fault):
    line = _execute((fault,))
    assert line["correct"] is False, line["checks"]


def test_fp8_control_fails_and_reads_beyond_the_program():
    prog = _execute()
    ctl = _execute(("control_fp8",))
    assert prog["correct"] is True and ctl["correct"] is False
    for number in ("prefill_logit_gap", "last_step_logit_gap"):
        assert ctl["checks"][number]["value"] > \
            2 * prog["checks"][number]["value"] > 0
