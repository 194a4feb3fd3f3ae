#!/usr/bin/env python3
"""What the port's spans (``repro_torch.trace``) show of a benchmark cell,
and what they cost.

    python tools/trace_check.py breakdown <cell> [--sync-debug]
    python tools/trace_check.py cost <cell> [--pairs 5 --seconds 20]

``breakdown`` runs the cell once with ``--trace 1`` (``bench/run.py``'s
``execute``), the program's spans annotated over the profiled window
(``trace.enable(annotate=True)``), and prints one JSON line: the run's
metrics; the ten program spans with the most host self time, each with
its count, its distinct requests and threads, its host inclusive and self
seconds, and the device seconds of the kernels launched inside it (by the
profiler's correlation of a kernel with its launch call); the device's
idle gaps charged as ``bench/harness._host_at`` charges them, with the
program's spans counted among the labels; and the idle seconds under each
label or span.  With ``--sync-debug`` the traced window runs under
``torch.cuda.set_sync_debug_mode("warn")`` and the line lists each place
that synchronised with the device, with the frames of this repository on
its stack.

``cost`` runs the cell ``--pairs`` times with tracing on
(``trace.enable()``, no profiler) and as many times off, in turns (the
side that goes first alternating; the two runs of a pair share a seed),
each a whole ``--trace 0`` run of ``--seconds``, after an untimed short
run.  It prints each run's end-to-end metrics and the per-layer metrics
that read without a profiler: the host-clock ones, and with tracing on
the program's span metrics over the unprofiled run.

``--device cpu --smoke`` rehearses either at the cells' smoke sizes.
Both modes go once ``bench/harness.py`` charges device time and idle gaps
to program spans and reads the recorder over its unprofiled window.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import harness as H  # noqa: E402
from bench import program_trace  # noqa: E402
from repro_torch import trace  # noqa: E402


def _bench_run():
    spec = importlib.util.spec_from_file_location("bench_run_tool",
                                                  ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------- breakdown
def _repo_frames(stack):
    here = Path(__file__).resolve()
    out = []
    for f in stack:
        p = Path(f.filename).resolve()
        if p != here and ROOT in p.parents:
            out.append(f"{p.relative_to(ROOT)}:{f.lineno} {f.name}")
    return out


def _sync_debugged(fn, sites):
    """``fn`` under the sync-debug mode, each warned place counted in
    ``sites`` by its message and the repository's frames."""
    def run():
        def hook(message, category, filename, lineno, file=None,
                 line=None):
            frames = _repo_frames(traceback.extract_stack()[:-1])
            key = (str(message).splitlines()[0][:100],
                   " <- ".join(reversed(frames[-4:])))
            sites[key] += 1
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return run


def traced(cell, seed, seconds, device, smoke=False, sites=None):
    """One ``--trace 1`` run of ``cell`` with the program's spans
    annotated over the profiled window (and under the sync-debug mode
    when ``sites`` is a Counter).  Returns (the result line, the
    readings, the profile)."""
    kept = {}
    profile, tprofile = H.profile, torch.profiler.profile

    class Keeping(tprofile):
        def __exit__(self, *exc):
            kept["prof"] = self
            return super().__exit__(*exc)

    def annotated(fn, dev):
        def run():
            trace.enable(annotate=True)
            try:
                fn()
            finally:
                trace.disable()
        torch.profiler.profile = Keeping
        try:
            return profile(run if sites is None
                           else _sync_debugged(run, sites), dev)
        finally:
            torch.profiler.profile = tprofile

    trace.collect()
    H.profile = annotated
    try:
        line, out = _bench_run().execute(cell, seed, seconds, True, device,
                                         time.perf_counter(), smoke=smoke)
    finally:
        H.profile = profile
    return line, out.readings, kept["prof"]


def _breakdown(prof, spans, device) -> dict:
    from torch.autograd import DeviceType
    cpu = DeviceType.CPU
    evs = prof.events()
    names = {s.name for s in spans}
    if device.type == "cuda":
        dev = [e for e in evs if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in H.labels and e.name not in names]
    else:
        dev = [e for e in evs if e.device_type == cpu
               and e.name.startswith("aten::") and (
                   e.cpu_parent is None
                   or not e.cpu_parent.name.startswith("aten::"))]
    dev.sort(key=lambda e: e.time_range.start)
    gaps, end = [], None
    for e in dev:
        if end is not None and e.time_range.start > end:
            gaps.append((end, e.time_range.start))
        end = e.time_range.end if end is None else max(end,
                                                       e.time_range.end)
    # the harness's charging, with the program's spans among its labels:
    # each gap to "<innermost label or span>/<aten op or python>"
    H.labels.update(names)
    idle, regions = collections.Counter(), collections.Counter()
    for (a, b), where in zip(gaps, H._host_at([0.5 * (a + b)
                                               for a, b in gaps], evs, cpu)):
        idle[where] += (b - a) * 1e-6
        if "/" in where:
            regions[where.rsplit("/", 1)[0]] += (b - a) * 1e-6
    # each device operation to the innermost span open at its launch (on
    # the CPU an operator is its own launch)
    if device.type == "cuda":
        launch = {e.id: e for e in evs
                  if e.device_type == cpu and e.name.startswith("cu")}
        at = [(launch[e.id].time_range.start, e) for e in dev
              if e.id in launch]
    else:
        at = [(e.time_range.start, e) for e in dev]
    at.sort(key=lambda x: x[0])
    span_evs = [e for e in evs if e.device_type == cpu and e.name in names]
    on_dev = collections.Counter()
    for (_, e), where in zip(at, H._host_at([t for t, _ in at], span_evs,
                                            cpu)):
        on_dev[where[:-len("/python")] if "/" in where else "(no span)"] \
            += (e.time_range.end - e.time_range.start) * 1e-6
    # the recorder's spans: host inclusive and self time, requests, threads
    incl, self_s, count = (collections.Counter() for _ in range(3))
    requests, threads = (collections.defaultdict(set) for _ in range(2))
    for s in spans:
        d = (s.end_ns - s.start_ns) * 1e-9
        incl[s.name] += d
        self_s[s.name] += d
        count[s.name] += 1
        requests[s.name].add(s.request)
        threads[s.name].add(s.thread)
        if s.parent is not None:
            self_s[spans[s.parent].name] -= d
    top = sorted(self_s, key=self_s.get, reverse=True)[:10]
    in_span = sum(v for k, v in regions.items() if k in names)
    return {
        "spans": [{"name": n, "count": count[n],
                   "requests": len(requests[n]), "threads": len(threads[n]),
                   "incl_s": incl[n], "self_s": self_s[n],
                   "device_s": on_dev.get(n, 0.0)} for n in top],
        "device_s_outside_spans": on_dev.get("(no span)", 0.0),
        "device_s_unlinked": sum(e.time_range.end - e.time_range.start
                                 for e in dev) * 1e-6
        - sum(on_dev.values()),
        "idle_gaps": [[k, v] for k, v in idle.most_common(10)],
        "idle_by_region": dict(regions.most_common()),
        "idle_in_program_span": in_span / sum(regions.values())
        if regions else None,
        "ops": len(dev)}


def breakdown(args, device) -> dict:
    sites = collections.Counter() if args.sync_debug \
        and device.type == "cuda" else None
    line, readings, prof = traced(args.cell, args.seed, args.seconds,
                                  device, args.smoke, sites)
    t = program_trace.summary(readings) or {"spans": [], "counters": {}}
    out = {"cell": args.cell, "correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "busy_s": line["device"].get("busy_s"),
           "window_s": line["device"].get("window_s"),
           "counters": t["counters"]}
    out.update(_breakdown(prof, t["spans"], device))
    if sites is not None:
        out["sync_sites"] = [[m, where, n] for (m, where), n
                             in sites.most_common()]
    return out


# ---------------------------------------------------------------- cost
def cost(args, device) -> dict:
    run = _bench_run()
    per_layer = H.load_json(ROOT / "BENCHMARK.json")["per_layer"]
    readers = {m["name"]: run.load_module(ROOT / "bench" / "metrics"
                                          / f"{m['name']}.py")
               for m in per_layer
               if args.cell in m.get("workloads", [args.cell])}
    # a short run first, untimed: the process's first run pays for its
    # builds and first calls
    run.execute(args.cell, args.seed, min(args.seconds, 1.0), False, device,
                time.perf_counter(), smoke=args.smoke)
    sides = {"on": [], "off": []}
    for p in range(args.pairs):
        for on in ((True, False) if p % 2 else (False, True)):
            trace.collect()
            if on:
                trace.enable()
            try:
                line, out = run.execute(args.cell, args.seed + p,
                                        args.seconds, False, device,
                                        time.perf_counter(),
                                        smoke=args.smoke)
            finally:
                trace.disable()
            r = out.readings
            r["program_trace"] = program_trace.summarize(*trace.collect())
            vals = {k: v["value"] for k, v in line["metrics"].items()}
            for name, reader in readers.items():
                v = reader.read(r)
                if v is not None:
                    vals[name] = v
            vals["correct"] = line["correct"]
            print(json.dumps({"tracing": on, "pair": p, **vals}),
                  file=sys.stderr, flush=True)
            sides["on" if on else "off"].append(vals)
    ratios = {}
    for k, v in sides["off"][0].items():
        if k != "correct" and all(k in s for s in sides["on"] + sides["off"]):
            ratios[k] = statistics.median(a[k] / b[k] for a, b in zip(
                sides["on"], sides["off"]))
    return {"cost": args.cell, "seconds": args.seconds, "pairs": args.pairs,
            "on": sides["on"], "off": sides["off"],
            "pair_ratio_median_on_over_off": ratios}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("breakdown", "cost"))
    ap.add_argument("cell", help="a workload of BENCHMARK.json")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 5)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--sync-debug", action="store_true")
    ap.add_argument("--pairs", type=int, default=5, help="cost: pairs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("trace_check: no CUDA device", file=sys.stderr)
        return 2
    out = breakdown(args, device) if args.mode == "breakdown" \
        else cost(args, device)
    out["device"] = H.card_line() if device.type == "cuda" else "cpu"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
