"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything
else is found by name under ``bench/``: ``workloads/<cell>.json`` (the
traffic and the driver), ``configs/<config>.json``, ``drivers/<driver>.py``
and ``metrics/<metric>.py``, one reader per metric.  With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the profiler's busy and window seconds and a
breakdown.  The last key of the line, ``checks``, holds each number the
run compared with its limit; they are also the last lines on standard
error.

The run needs the cards the cell asks for: without them it exits with
code 2 and prints no result.  It also refuses to print a result if
``jax``, ``jaxlib``, ``flax``, the JAX package ``repro`` or the JAX
benchmarks (``benchmarks``) were loaded into its process.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()          # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_module(path: Path):
    """The module in ``path`` (file names may hold dots, as metric names
    do)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    name = "bench_" + path.parent.name + "_" + \
        path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t0: float, smoke: bool = False, plant=(), root: Path = ROOT):
    """Run cell ``workload`` of ``root``'s ``BENCHMARK.json`` on ``device``.
    Returns (the result line as a dict, the driver's Outcome)."""
    from bench import harness as H
    bench = root / "bench"
    spec = H.load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = cells[workload]
    wl = H.merged(H.load_json(bench / "workloads" / f"{workload}.json"),
                  smoke)
    if wl["config"] != entry["config"]:
        raise ValueError(f"{workload}: its file names config "
                         f"{wl['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    cfg = H.merged(H.load_json(bench / "configs" / f"{entry['config']}.json"),
                   smoke)
    driver = load_module(bench / "drivers" / f"{wl['driver']}.py")
    cell = H.Cell(name=workload, config=cfg, workload=wl, seed=seed,
                  seconds=seconds, trace=trace, device=device, t0=t0,
                  smoke=smoke, plant=tuple(plant))
    out = driver.run(cell)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        reader = load_module(bench / "metrics" / f"{m['name']}.py")
        value = reader.read(out.readings)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = H.device_info(device, entry["chips"], out.memory_peak_bytes)
    if trace and out.trace is not None:
        dev.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    line = {"correct": all(c.ok for c in out.checks) and out.failed == 0,
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in out.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in out.trace.idle_gaps]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # every build and kernel cache at a fixed place inside the checkout
    cache = BENCH / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    from bench import harness as H
    chips = {w["name"]: w["chips"] for w in
             H.load_json(ROOT / "BENCHMARK.json")["workloads"]}
    if args.workload not in chips:
        print(f"bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    marks = H.Stages(T0)
    import torch
    marks.mark("import torch")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print(f"bench: {args.workload} needs {chips[args.workload]} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    marks.mark("CUDA found")
    line, _ = execute(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), T0)
    bad = H.forbidden_loaded()
    if bad:
        print(f"bench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    print(f"bench: {H.card_line()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
