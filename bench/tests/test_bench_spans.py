"""The metrics that read the program's own spans and counters
(``bench/program_trace.py``), on the CPU rehearsal of each cell with
``--trace 1``: each reads a number; the NIC's three stage groups account
for the step; the program's spans, annotated, add no device operation;
the profiler's copies of the spans are the recorder's, at one clock
offset; and ``tools/trace_check.py`` charges a run's time to the spans
and reads the span metrics without the profiler."""
import importlib.util
import math
import statistics
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
NIC = "nic.fig9-complex.in16"
TRAIN = "train.mamba2-780m.ingest-b4s2048"
SERVE = "serve.mamba2-780m.b16-p512-g128"
NEW = {NIC: ["nic.ingress_ms_per_step", "nic.handlers_ms_per_step",
             "nic.writeback_ms_per_step", "nic.host_syncs_per_step"],
       TRAIN: ["train.forward_ms_per_step", "train.backward_ms_per_step",
               "train.optimizer_ms_per_step", "train.host_syncs_per_step"],
       SERVE: ["serve.mixer_ms_per_decode_step"]}


def _execute(cell, seed=2 ** 31 + 77):
    # a window that holds a whole served batch on a loaded CPU
    seconds = 3.0 if cell == SERVE else 0.5
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from repro_torch import trace
    trace.collect()               # nothing left over from another run
    spec = importlib.util.spec_from_file_location("bench_run_spans",
                                                  ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.execute(cell, seed, seconds, True, torch.device("cpu"),
                       time.perf_counter(), smoke=True)


@pytest.mark.parametrize("cell", [NIC, TRAIN, SERVE])
def test_every_new_metric_reads_a_number(cell):
    line, out = _execute(cell)
    assert line["correct"] is True
    got = {k: line["metrics"][k]["value"] for k in NEW[cell]}
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    spans = out.readings["program_trace"]["count"]
    if cell == NIC:
        # 19 scatter_set_ calls and the poll's count read a step, two more
        # reads on the round's completion step
        steps = spans["spin_nic.step"]
        assert spans["spin_nic.pop_counters"] == steps
        assert got["nic.host_syncs_per_step"] == (20 * steps + 2) / steps
        # the three groups are the step less its own few lines: inside
        # the step's time and nearly all of it
        step_ms = out.readings["program_trace"]["s"]["spin_nic.step"] \
            * 1e3 / steps
        groups = sum(got[k] for k in NEW[NIC][:3])
        assert 0.9 * step_ms <= groups <= step_ms
    elif cell == TRAIN:
        # the loop's waits (the prologue's, then two a step but the
        # last's), and each ingest call's three copies in and one scatter
        assert got["train.host_syncs_per_step"] == 2.0 + 4.0
        assert spans["ssm.chunked"] == 2 * spans["trainer.step"]  # 2 layers
    else:
        assert spans["ssm.decode"] == 2 * spans["serve.step"]


def _trace_check():
    spec = importlib.util.spec_from_file_location(
        "trace_check_spans", ROOT / "tools" / "trace_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _annotated(cell, seed=2 ** 31 + 77):
    """The cell's ``--trace 1`` run with the program's spans annotated
    over the profiled window (``tools/trace_check.py``'s)."""
    seconds = 3.0 if cell == SERVE else 0.5
    return _trace_check().traced(cell, seed, seconds, torch.device("cpu"),
                                 smoke=True)


def test_program_spans_add_no_device_operation(monkeypatch):
    from repro_torch import trace
    with_spans, readings, _ = _annotated(NIC)
    assert readings["program_trace"]["count"]["spin_nic.step"] > 0
    monkeypatch.setattr(trace, "span", lambda *a, **k: trace._NULL)
    monkeypatch.setattr(trace, "count", lambda *a, **k: None)
    without, out = _execute(NIC)
    assert out.readings["program_trace"] is None
    assert set(without["metrics"]).isdisjoint(NEW[NIC])
    assert with_spans["metrics"]["nic.kernels_per_step"] == \
        without["metrics"]["nic.kernels_per_step"]


def test_profiler_copies_of_spans_are_the_recorders():
    """Same names in the same order, each span's end at one offset from
    the recorder's (``perf_counter_ns`` against the profiler's clock)."""
    from torch.autograd import DeviceType
    _, readings, prof = _annotated(NIC)
    spans = [s for s in readings["program_trace"]["spans"] if s.end_ns]
    names = {s.name for s in spans}
    copies = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CPU and e.name in names),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    assert len(spans) > 20
    assert [e.name for e in copies] == [s.name for s in spans]
    offsets = [s.end_ns * 1e-3 - e.time_range.end
               for s, e in zip(spans, copies)]
    mid = statistics.median(offsets)
    assert max(abs(o - mid) for o in offsets) <= 1000.0      # 1 ms, in us


def test_trace_check_breakdown_charges_idle_time_and_ops_to_spans():
    tc = _trace_check()
    args = tc.argparse.Namespace(cell=NIC, seed=2 ** 31 + 78, seconds=0.5,
                                 smoke=True, sync_debug=False)
    out = tc.breakdown(args, torch.device("cpu"))
    assert out["correct"] is True
    assert set(NEW[NIC]) <= set(out["metrics"])
    # a step's spans share its request (the NIC's count of steps; the
    # poll has none), on one thread
    assert len(out["spans"]) == 10
    for s in out["spans"]:
        assert s["name"].startswith("spin_nic.") and s["threads"] == 1
        assert s["requests"] == (1 if s["name"] == "spin_nic.pop_counters"
                                 else s["count"])
        assert 0.0 <= s["self_s"] <= s["incl_s"] and s["device_s"] >= 0.0
    assert out["device_s_outside_spans"] >= 0.0
    assert abs(out["device_s_unlinked"]) < 1e-6
    assert 0.0 < out["idle_in_program_span"] <= 1.0
    assert any(k.startswith("spin_nic.") for k in out["idle_by_region"])


def test_trace_check_cost_reads_span_metrics_without_the_profiler():
    tc = _trace_check()
    args = tc.argparse.Namespace(cell=NIC, seed=2 ** 31 + 79, seconds=0.5,
                                 smoke=True, pairs=1)
    out = tc.cost(args, torch.device("cpu"))
    (on,), (off,) = out["on"], out["off"]
    assert on["correct"] and off["correct"]
    assert set(NEW[NIC]) <= set(on) and set(NEW[NIC]).isdisjoint(off)
    assert "nic.host_ms_per_step" in on and "nic.host_ms_per_step" in off
    assert "nic.kernels_per_step" not in on          # needs a profile
    assert "nic.host_ms_per_step" in out["pair_ratio_median_on_over_off"]
