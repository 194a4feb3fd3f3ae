"""Readings for the limits of ``correct``: run a cell on several seeds in
one process, the program as it is or with a fault or the control planted
under its timed path, and print each run's compared numbers.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \\
        [--plant control_fp8] [--seconds 6]

Plants (each driver takes those that apply to it): ``first_write_wins``
(the NIC's control: the host DMA keeps the first of repeated writes),
``control_fp8`` (the reference with float8 products in the program's
place), ``state_unchanged``, ``half_batch``, ``altered_answer``.  The
benchmark's own runs plant nothing.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--plant", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import run
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    plant = tuple(p for p in args.plant.split(",") if p)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line, out = run.execute(args.workload, seed, args.seconds, False,
                                torch.device("cuda"), t0, plant=plant)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "plant": list(plant), "correct": line["correct"],
                          "failed": line["failed"], "checks": {
                              k: v["value"] for k, v in
                              line["checks"].items()},
                          "diag": out.readings.get("diag")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
