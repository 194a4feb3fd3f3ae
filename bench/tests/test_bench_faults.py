"""Each cell's run with its timed path broken underneath (the harness's
look for a card skipped, the CPU at the smoke size) must come out not
correct; and each control must read beyond the program on the same seed.
The faults: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced."""
import importlib.util
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
NIC = "nic.fig9-complex.in16"
TRAIN = "train.mamba2-780m.ingest-b4s2048"
SERVE = "serve.mamba2-780m.b16-p512-g128"


def _execute(cell, plant=(), seed=2 ** 31 + 101):
    # a window that holds a whole served batch on a loaded CPU
    seconds = 3.0 if cell == SERVE else 0.5
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    spec = importlib.util.spec_from_file_location("bench_run_faults",
                                                  ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.execute(cell, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter(), smoke=True, plant=plant)[0]


@pytest.mark.parametrize("cell", [NIC, TRAIN, SERVE])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered_answer"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    line = _execute(cell, (fault,))
    assert line["correct"] is False, line["checks"]


def test_nic_control_first_write_wins_is_not_correct():
    line = _execute(NIC, ("first_write_wins",))
    assert line["correct"] is False
    assert line["checks"]["buffer_bytes_wrong"]["value"] > 0


def test_nic_plant_is_undone_after_the_run():
    _execute(NIC, ("first_write_wins",))
    assert _execute(NIC)["correct"] is True


@pytest.mark.parametrize("cell,number", [
    (TRAIN, "grad_norm_gap_median_leaf"),
    (SERVE, "served_logit_gap"),
    (SERVE, "prefill_logit_gap"),
    (SERVE, "last_step_logit_gap")])
def test_fp8_control_reads_beyond_the_program(cell, number):
    prog = _execute(cell)["checks"][number]["value"]
    ctl = _execute(cell, ("control_fp8",))["checks"][number]["value"]
    assert ctl > 2 * prog and ctl > 0
