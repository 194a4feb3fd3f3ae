"""The harness on the CPU: the rehearsal of every cell at its smoke size
(the shape of the result line), the file contract of BENCHMARK.json, what
the command does without a card, and what a run may import."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run():
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_run_cli",
                                                  ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seconds(cell):
    """A window that holds a whole served batch on a loaded CPU."""
    return 3.0 if cell.startswith("serve.") else 0.5


def _reported(cell, trace):
    kind = "per_layer" if trace else "end_to_end"
    return {m["name"] for m in SPEC[kind]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_rehearsal_line_shape(cell, trace):
    line, _ = _run().execute(cell, 2 ** 31 + 11, _seconds(cell), trace,
                             torch.device("cpu"), time.perf_counter(),
                             smoke=True)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    # the CPU has no device memory peak to read
    assert set(line["metrics"]) == _reported(cell, trace) - {"train.peak_GB"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert line["device"]["platform"] == "cpu"      # never a device number
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line)


def test_benchmark_json_follows_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {m["name"]: m for m in SPEC["per_layer"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + list(layers) + CELLS + \
        [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in list(e2e.values()) + list(layers.values()):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers.values():
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "workloads" / f"{w['name']}.json").is_file()
        reported = _reported(w["name"], False)
        assert "setup_s" in reported and len(reported) >= 2
        # every per-layer metric of the cell moves a metric it reports
        per = [m for m in layers.values()
               if w["name"] in m.get("workloads", [w["name"]])]
        assert per and all(m["moves"] in reported for m in per)


def test_command_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "3000000000", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_command_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_references_nothing_of_the_port():
    files = [p for p in (ROOT / "bench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        assert not set(_top_imports(p)) & FORBIDDEN, p
    for p in (ROOT / "bench" / "ref").rglob("*.py"):
        assert "repro_torch" not in set(_top_imports(p)), p


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import importlib.util\n"
        "s = importlib.util.spec_from_file_location('r', "
        f"{str(ROOT / 'bench' / 'run.py')!r})\n"
        "r = importlib.util.module_from_spec(s); s.loader.exec_module(r)\n"
        f"for c in {CELLS!r}:\n"
        "    r.execute(c, 5, 0.2, False, torch.device('cpu'),\n"
        "              time.perf_counter(), smoke=True)\n"
        "from bench import harness\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN


def test_a_new_workload_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries; no file of the harness is
    edited."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    src = tmp_path / "bench" / "workloads"
    wl = json.loads((src / "nic.fig9-complex.in16.json").read_text())
    wl["traffic"]["messages"] = 8
    (src / "nic.fig9-complex.in8.json").write_text(json.dumps(wl))
    (tmp_path / "bench" / "metrics" / "nic.messages_done.py").write_text(
        "def read(r):\n    return r.get('messages_done')\n")
    spec["workloads"].append(dict(spec["workloads"][0],
                                  name="nic.fig9-complex.in8",
                                  traffic="fig9-complex.in8"))
    spec["per_layer"].append({
        "name": "nic.messages_done", "unit": "messages", "better": "higher",
        "source": "host_clock", "layer": "device", "moves":
        "nic_goodput_MBps", "workloads": ["nic.fig9-complex.in8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    line, _ = _run().execute("nic.fig9-complex.in8", 9, 0.3, True,
                             torch.device("cpu"), time.perf_counter(),
                             smoke=True, root=tmp_path)
    assert line["correct"]
    assert line["metrics"]["nic.messages_done"]["value"] > 0
