#!/usr/bin/env python3
"""Train through ``Trainer(mesh=...)`` on several ranks of one host: each
rank a process with its own card (NCCL) or a CPU process (gloo), the mesh
from ``launch/mesh.make_host_mesh(model)``.

    python tools/mesh_train.py --ranks 4 --model 2 --arch gemma3-1b
    python tools/mesh_train.py --ranks 4 --model 2 --smoke --device cpu

Every rank draws the same weights from ``--seed`` and one
``shapes.train_batch_specs`` batch; the Trainer places both (FSDP with
``--fsdp``).  Before the steps, rank 0 takes the plain (unsharded) loss of
the same weights and batch on its own device, and the first mesh step's
loss must lie within ``--tol`` relative of it.  Then ``--steps`` steps:
per step the loss, the grad norm, ms on the host clock (synchronized)
and, on CUDA, K4's and K4b's launches on each rank; the peak device
memory of each rank last.  Exits nonzero if a check fails.
"""
import argparse
import datetime
import json
import os
import socket
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank, args, port, out):
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=args.ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_host_mesh(args.model, device_type=args.device)
        cfg = (configs.get_smoke_config(args.arch) if args.smoke
               else configs.get_config(args.arch))
        model = build_model(cfg)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 shapes.train_batch_specs(cfg, args.seq, args.batch,
                                          rng=np.random.default_rng(
                                              args.seed)).items()}
        params = model.init(torch.Generator(device=dev).manual_seed(
            args.seed))
        plain = None
        if rank == 0:
            with torch.no_grad():
                plain = float(model.loss_fn(params, batch)[0])
        ost = opt.init(params.tree())
        step = Trainer(model, opt.OptConfig(lr=args.lr, warmup_steps=1,
                                            total_steps=20),
                       TrainerConfig(fsdp=args.fsdp),
                       mesh=mesh).build_step(batch)
        rows = []
        for _ in range(args.steps):
            k4.launches = k4.bwd_launches = 0
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, ost, m = step(params, ost, batch)
            loss = float(m["loss"])
            if cuda:
                torch.cuda.synchronize()
            rows.append(dict(loss=loss, grad_norm=float(m["grad_norm"]),
                             ms=(time.perf_counter() - t0) * 1e3,
                             k4=k4.launches, k4b=k4.bwd_launches))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        out[rank] = dict(rows=rows, plain=plain, peak=peak,
                         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--tol", type=float, default=2e-3)
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"mesh_train: {args.ranks} ranks need as many cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.device == "cuda":           # once, before the ranks load them
        from repro_torch.kernels import build
        build.build_all(["flash_attention", "flash_attention_bwd"])
    import torch.multiprocessing as mp
    out = mp.Manager().dict()
    mp.spawn(rank_main, args=(args, _free_port(), out), nprocs=args.ranks)
    ranks = [out[r] for r in range(args.ranks)]
    for r, res in enumerate(ranks):
        print(json.dumps(dict(rank=r, **res)), flush=True)
    first = ranks[0]["rows"][0]["loss"]
    rel = abs(first - ranks[0]["plain"]) / abs(ranks[0]["plain"])
    losses = [x["loss"] for x in ranks[0]["rows"]]
    same = all([x["loss"] for x in res["rows"]] == losses for res in ranks)
    falls = ranks[0]["rows"][-1]["loss"] < first
    print(f"mesh_train: {args.arch} on {ranks[0]['mesh']} (fsdp "
          f"{args.fsdp}): first mesh loss {first:.6f} against the plain "
          f"loss {ranks[0]['plain']:.6f}, relative {rel:.3e} (limit "
          f"{args.tol}); losses equal on every rank {same}; falls {falls}",
          flush=True)
    return 0 if (rel <= args.tol and same and falls) else 1


if __name__ == "__main__":
    sys.exit(main())
