"""Aggregate the dry run's rows (``experiments/dryrun_torch/*.json``) into
tables; PyTorch port of ``repro.launch.report``.

Recomputes the roofline terms from the raw stored counts (the counting
mode's FLOPs and bytes accessed, and the collective bytes), so that a
change of the formulas or the card's constants needs no new dry run.
The port's rows carry no probe (``probe`` null: its layer loop counts
every layer).

    PYTHONPATH=src python -m repro_torch.launch.report [--markdown out.md]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import List, Optional

from repro_torch import configs
from repro_torch.configs import shapes as shp
from repro_torch.launch import roofline as rf
from repro_torch.launch.dryrun import OUT_DIR


def load_rows(out_dir: Optional[str] = None) -> List[dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(out_dir or OUT_DIR, "*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def recompute(row: dict) -> dict:
    """Fresh roofline terms from raw stored numbers."""
    if row.get("status") != "ok":
        return row
    cfg = configs.get_config(row["arch"])
    if row.get("overrides"):
        cfg = dataclasses.replace(cfg, **row["overrides"])
    suite = shp.SHAPES[row["shape"]]
    kind = row.get("kind", suite.kind)
    ca = row.get("cost_analysis", {})
    flops = float(ca.get("flops", 0.0))
    byt = float(ca.get("bytes accessed", 0.0))
    coll = float(row.get("collectives", {}).get("total", 0.0))
    tokens = (suite.seq_len * suite.global_batch
              if kind in ("train", "prefill") else suite.global_batch)
    terms = rf.derive(row["arch"], row["shape"], row["mesh"],
                      row["chips"], flops, byt, coll, cfg, tokens,
                      bytes_per_device=row.get(
                          "analytic_state_bytes_per_device"),
                      note=("fsdp" if row.get("fsdp") else ""),
                      fwd_only=(kind != "train"))
    out = dict(row)
    out["roofline"] = terms.row()
    return out


def dominant_time(r: dict) -> float:
    t = r["roofline"]
    return max(t["compute_s"], t["memory_s"], t["collective_s"])


def roofline_fraction(r: dict) -> float:
    """compute term / dominant term — how close the cell is to being
    compute-(roof)-bound; 1.0 = at the compute roofline."""
    t = r["roofline"]
    return t["compute_s"] / max(dominant_time(r), 1e-30)


def markdown(rows: List[dict]) -> str:
    variants = [r for r in rows if r.get("variant")]
    rows = [r for r in rows if not r.get("variant")]
    ok = [r for r in rows if r.get("status") == "ok"]
    skipped = [r for r in rows if r.get("status") == "skipped"]
    failed = [r for r in rows if r.get("status") not in ("ok", "skipped")]
    lines = []
    lines.append("### Dry-run matrix\n")
    lines.append(f"OK: {len(ok)}  skipped (documented): {len(skipped)}  "
                 f"failed: {len(failed)}\n")
    lines.append("| arch | shape | mesh | chips | kind | trace s | "
                 "state GB/dev | fits 80G | note |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    for r in ok:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} "
            f"| {r.get('kind','')} | {r.get('trace_s','')} "
            f"| {r['analytic_state_bytes_per_device']/1e9:.2f} "
            f"| {'yes' if r['fits_h100_hbm_80g'] else 'NO'} "
            f"| {r['roofline'].get('note','')} |")
    for r in skipped:
        lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                     f"| — | — | — | SKIP: {r['reason'][:60]} |")
    lines.append("\n### Roofline terms (single-pod)\n")
    lines.append("| arch | shape | compute s | memory s | collective s | "
                 "bottleneck | roofline frac | MODEL/HLO | "
                 "what moves the dominant term |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    for r in ok:
        if r["mesh"] != "pod":
            continue
        t = r["roofline"]
        frac = roofline_fraction(r)
        hint = {
            "compute": "already compute-bound: fuse/skip redundant flops",
            "memory": "cut HBM traffic: bf16 logits, fused CE, remat tune",
            "collective": "reshard / overlap collectives with compute",
        }[t["bottleneck"]]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3e} "
            f"| {t['memory_s']:.3e} | {t['collective_s']:.3e} "
            f"| {t['bottleneck']} | {frac:.3f} "
            f"| {t['useful_ratio']:.3f} | {hint} |")
    if variants:
        lines.append("\n### Perf-iteration variants\n")
        lines.append("| arch | shape | mesh | variant | compute s | "
                     "memory s | collective s | bottleneck |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for r in variants:
            if r.get("status") != "ok":
                lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                             f"| {r['variant']} | FAILED | | | |")
                continue
            t = r["roofline"]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                f"| {r['variant']} | {t['compute_s']:.3e} "
                f"| {t['memory_s']:.3e} | {t['collective_s']:.3e} "
                f"| {t['bottleneck']} |")
    if failed:
        lines.append("\n### FAILED cells\n")
        for r in failed:
            lines.append(f"- {r['arch']} × {r['shape']} × {r['mesh']}: "
                         f"{r.get('error','')[:200]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--out", default=None,
                    help=f"the dry run's row directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    rows = [recompute(r) for r in load_rows(args.out)]
    md = markdown(rows)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
        print(f"wrote {args.markdown}")
    else:
        print(md)


if __name__ == "__main__":
    main()
