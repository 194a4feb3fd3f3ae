"""What every driver shares: the cell a run measures, the readings it
hands to the metric readers, the comparison that decides ``correct``, the
reduction of a ``torch.profiler`` trace, and the guard against JAX.

A driver (``drivers/<name>.py``) exposes ``run(cell) -> Outcome``.  The
readers (``metrics/<metric>.py``) each expose ``read(readings)``, which
returns a number or None where the run has nothing to read.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import re
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclasses.dataclass
class Cell:
    """One run of one cell.  ``smoke`` (the CPU rehearsal of the tests)
    takes the ``smoke`` overrides of the configuration and the workload;
    ``plant`` names faults or a control put under the timed path (tests
    and ``bench/control.py`` only)."""
    name: str
    config: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: object                # torch.device
    t0: float                     # host clock at process start
    smoke: bool = False
    plant: Tuple[str, ...] = ()


@dataclasses.dataclass
class Check:
    """One number compared with its limit; the run is correct when every
    value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    readings: dict
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional["TraceSummary"] = None


@dataclasses.dataclass
class TraceSummary:
    busy_s: float                 # union of device operation intervals
    window_s: float               # host clock over the traced stretch
    ops: int                      # device operations (kernels and copies)
    device_ops: List[Tuple[str, float]]   # names with the most device time
    idle_gaps: List[Tuple[str, float]]    # idle time by what the host did

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merged(base: dict, smoke: bool) -> dict:
    """``base`` without its ``smoke`` key, updated by it when ``smoke``."""
    out = {k: v for k, v in base.items() if k != "smoke"}
    if smoke:
        for k, v in base.get("smoke", {}).items():
            out[k] = dict(out[k], **v) if isinstance(v, dict) \
                and isinstance(out.get(k), dict) else v
    return out


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0 < q < 1) of ``values`` by linear interpolation
    between order statistics (``statistics.quantiles``' inclusive rule)."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    n = 1000
    return float(statistics.quantiles(v, n=n, method="inclusive")
                 [round(q * n) - 1])


labels = set()          # the names ``label`` has given regions


def label(name: str, on: bool):
    """A ``torch.profiler.record_function`` region while tracing, nothing
    otherwise."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    labels.add(name)
    return record_function(name)


class Stages:
    """Host-clock marks of a run's set-up, printed to standard error as
    they come (where set-up time goes)."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0

    def mark(self, what: str) -> None:
        now = time.perf_counter()
        print(f"bench: set-up {what}: {now - self.last:.3f} s "
              f"(at {now - self.t0:.3f} s)", file=sys.stderr, flush=True)
        self.last = now


def profile(fn: Callable[[], None], device) -> TraceSummary:
    """``fn`` under ``torch.profiler`` (CPU and CUDA activities), with a
    synchronise on each side.  Busy time is the union of the device
    operations' intervals; each idle gap between them is charged to the
    innermost host region (a ``label`` or an aten operator) open at its
    midpoint."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    sync(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    evs = prof.events()
    if device.type == "cuda":
        # the device side of a ``label`` region is an annotation spanning
        # the region's kernels, not an operation: left out
        on_dev = [e for e in evs if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in labels]
    else:
        # the CPU rehearsal: top-level aten operators stand in for device
        # operations (never reported as a device number)
        on_dev = [e for e in evs if e.device_type == DeviceType.CPU
                  and e.name.startswith("aten::") and (
                      e.cpu_parent is None
                      or not e.cpu_parent.name.startswith("aten::"))]
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in on_dev), key=lambda t: t[0])
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    per_op = collections.Counter()
    busy, cur, gaps = 0.0, None, []
    for a, b, name in dev:
        per_op[short_name(name)] += (b - a) * 1e-6
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += cur[1] - cur[0]
    by_host = collections.Counter()
    for (a, b), where in zip(gaps, _host_at([0.5 * (a + b) for a, b in gaps],
                                            evs, DeviceType.CPU)):
        by_host[where] += (b - a) * 1e-6
    print(f"bench: trace of {len(dev)} device operations read in "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr, flush=True)
    return TraceSummary(busy_s=busy * 1e-6, window_s=wall, ops=len(dev),
                        device_ops=per_op.most_common(10),
                        idle_gaps=by_host.most_common(10))


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name within ``width`` characters: a long
    templated kernel name becomes its kernel and functor identifiers and
    its first element type."""
    name = name[5:] if name.startswith("void ") else name
    if len(name) <= width:
        return name
    keys = []
    for t in re.findall(r"\w*(?:Functor|_kernel|Reduce|Op)\w*", name):
        if t and t not in keys:
            keys.append(t)
    dtype = re.search(r"c10::BFloat16|c10::Half|double|float|long|int|bool",
                      name)
    short = " ".join(keys + ([dtype.group(0)] if dtype else []))
    return (short or name)[:width]


def _host_at(times: List[float], evs, cpu) -> List[str]:
    """For each of the ascending ``times``, what the host was doing: the
    innermost open ``label`` region and aten operator, over all host
    threads (each thread's regions nest, so a stack per thread, swept
    once)."""
    per_thread = collections.defaultdict(list)
    for e in evs:
        if e.device_type == cpu and (e.name.startswith("aten::")
                                     or e.name in labels):
            per_thread[e.thread].append((e.time_range.start,
                                         e.time_range.end, e.name))
    sweeps = []
    for ivs in per_thread.values():
        ivs.sort(key=lambda t: (t[0], -t[1]))
        sweeps.append([ivs, 0, []])          # events, next index, stack
    out = []
    for t in times:
        best = None
        for sw in sweeps:
            ivs, i, stack = sw
            while i < len(ivs) and ivs[i][0] <= t:
                while stack and stack[-1][1] < ivs[i][0]:
                    stack.pop()
                stack.append(ivs[i])
                i += 1
            sw[1] = i
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[-1][0]):
                best = list(stack)
        if best is None:
            out.append("python")
            continue
        region = [s[2] for s in best if s[2] in labels]
        ops = [s[2] for s in best if s[2].startswith("aten::")]
        out.append("/".join(region[-1:] + (ops[-1:] or ["python"])))
    return out


def device_info(device, count: int, peak: int) -> Dict:
    if device.type == "cuda":
        import torch
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": int(peak)}


def card_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed ({e})"
    out = r.stdout.strip().splitlines()
    return out[0] if r.returncode == 0 and out else "nvidia-smi failed"
