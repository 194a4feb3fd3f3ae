"""Training command line; PyTorch port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --steps 8 --batch 4 --seq 1024 --spin-ingest
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 4 --spin-ingest

Wires together: config registry -> model -> AdamW -> packetized SLMP/DDT
data pipeline with SpinIngest (the paper's offloaded datatype processing,
kernels K1 and K2) double-buffered against the train step -> atomic
checkpoints -> fault supervisor with bounded restarts.  The flags are the
JAX launcher's, plus ``--device`` (default CUDA; raises without a GPU).
Weights are drawn from ``--seed`` with a ``torch.Generator`` on the
device.  ``--smoke`` selects the reduced same-family config (CPU only on
the GPU path: its head_dim is not one K4 takes).

With ``--spin-ingest`` the loop issues step t, then the ingest of batch
t + 1 behind it on the device, and measures the paper's overlap ratio as
the JAX launcher does: the time to wait for the step's loss (T_MM), then
for the next batch (T_Poll), R = T_MM / (T_MM + T_Poll).  Nothing inside
the step waits for the device.  Like the JAX launcher it has no mesh
flag: the mesh path is ``Trainer(mesh=...)`` with a ``DeviceMesh`` from
``launch/mesh.py``, driven from a script that starts the process group.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import card_line, configs, resolve_device
from repro_torch.launch import faults
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as datalib
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig, block


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-torch-train-ckpt"))
    ap.add_argument("--spin-ingest", action="store_true",
                    help="feed training through the packetized SLMP/DDT "
                         "sPIN pipeline (paper §V-C) with overlap")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = build_model(cfg)
    print(f"[train] arch={cfg.name} params~{cfg.param_count():,} "
          f"steps={args.steps} batch={args.batch} seq={args.seq} "
          f"spin_ingest={args.spin_ingest} on "
          f"{card_line() if dev.type == 'cuda' else 'cpu'}")

    ocfg = opt.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                         total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, microbatches=args.microbatches,
                         log_every=max(args.steps // 20, 1),
                         ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)

    def make_state():
        params = model.init(torch.Generator(device=dev).manual_seed(
            args.seed))
        return params, opt.init(params.tree())

    def run(state, attempt):
        params, ost = state
        trainer = Trainer(model, ocfg, tcfg)
        if args.spin_ingest:
            pipe = datalib.PacketizedPipeline(
                vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                seed=args.seed)
            ingest = datalib.SpinIngest(pipe, device=dev)
            feeds = datalib.prefetch_iterator(pipe, args.steps)
            # double-buffered: ingest t+1 overlaps train step t
            step_fn = trainer.build_step()
            t_mm = t_poll = 0.0
            step_secs = []
            batch = ingest(next(feeds))
            hist = []
            for i, feed in enumerate(feeds):
                t_start = time.perf_counter()
                params, ost, metrics = step_fn(params, ost, batch)
                nxt = ingest(feed)                     # overlaps step
                t0 = time.perf_counter()
                block(metrics["loss"])
                t1 = time.perf_counter()
                block(nxt["tokens"])
                t2 = time.perf_counter()
                t_mm += t1 - t0
                t_poll += t2 - t1
                step_secs.append(t2 - t_start)
                batch = nxt
                if (i + 1) % tcfg.log_every == 0:
                    hist.append({"step": i + 1,
                                 "loss": float(metrics["loss"])})
                    print(f"  step {i+1:5d} loss "
                          f"{float(metrics['loss']):.4f}")
                if tcfg.ckpt_every and (i + 1) % tcfg.ckpt_every == 0:
                    ckpt.save(tcfg.ckpt_dir, i + 1, (params.tree(), ost))
            r = t_mm / max(t_mm + t_poll, 1e-12)
            print(f"[train] overlap ratio R = {r:.4f} "
                  f"(t_train={t_mm:.2f}s t_poll={t_poll:.2f}s)")
            return {"history": hist, "overlap_ratio": r, "t_train_s": t_mm,
                    "t_poll_s": t_poll, "step_secs": step_secs}
        else:
            corpus = datalib.SyntheticCorpus(cfg.vocab, seed=args.seed)

            def batches():
                for i in range(args.steps):
                    toks = torch.as_tensor(
                        corpus.batch(i, args.batch, args.seq), device=dev)
                    yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

            p2, o2, hist = trainer.fit(params, ost, batches(),
                                       resume=attempt > 0)
            for h in hist[-3:]:
                print(f"  step {h['step']:5d} loss {h['loss']:.4f}")
            return {"history": hist,
                    "stragglers": trainer.straggler_events}

    result, report = faults.run_with_restarts(
        make_state, run, max_restarts=args.max_restarts)
    if not report.succeeded:
        raise SystemExit(f"training failed after {report.restarts} "
                         f"restarts: {report.errors}")
    print(f"[train] done (restarts={report.restarts})")
    return result


if __name__ == "__main__":
    main()
