"""Multi-pod dry run on fake tensors: is the distribution config coherent,
and what does one step cost a rank?  PyTorch port of
``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell:
  * start a process group of 256 (single pod, 16 x 16) or 512 ranks
    (2 x 16 x 16) on ``torch.distributed``'s ``fake`` backend, in this one
    process, at rank 0: every collective returns at once;
  * take ``make_production_mesh`` over it, on CUDA where this build of
    PyTorch has it, else on the CPU (autograd cannot record fake CUDA
    tensors in a CPU-only build: it has no CUDA device guard);
  * under ``FakeTensorMode`` (shapes, no memory): build the parameters
    with ``model.init``, place them (``Trainer``'s placements; ``fsdp``
    for ``FSDP_ARCHS``, ``TrainerConfig.pure_dp`` for ``--pure-dp``; the
    manual-DP step's own for ``--manual-dp-int8``), place the batch and,
    for decode, a cache (``cache_shardings``; sequence-split for
    ``long_500k``), and run one step: ``Trainer.build_step()``'s train
    step, ``manual_dp.build``'s, ``Model.prefill`` or
    ``Model.decode_step`` (then argmax, as the JAX step does, over the
    vocabulary gathered whole);
  * count that step under ``launch.roofline.CountingMode``: rank 0's
    FLOPs (K4 and K4b by their custom ops' formulas, in place of the JAX
    package's statically unrolled attention blocks), bytes accessed and
    collective bytes by kind;
  * write one JSON row per cell under ``experiments/dryrun_torch/``.

Rows keep the JAX package's keys, but: ``trace_s`` (build and the traced
step) for ``compile_s``; ``fits_h100_hbm_80g`` for ``fits_v5e_hbm_16g``;
``probe`` null (the port's Python layer loop runs every layer, so no
scan-once correction is needed); ``memory_analysis`` and ``hlo_bytes``
null (no compiler); ``cost_analysis`` holds the counting mode's ``flops``
and ``bytes accessed``; ``kernels`` counts the custom-op calls of K4 and
K4b; ``device`` is the mesh's device type.
``analytic_state_bytes_per_device`` sums the local shards' bytes of the
JAX package's state lists: parameters, mu and nu (and the error state
for manual DP) for train, the parameters for prefill, the parameters and
the cache for decode.

Knobs the port has not: ``--block-q`` and ``--block-k`` (K4 fixes its
own tiles) and ``--scores-dtype`` (K4 scores in float32) are refused;
``--no-probe`` is accepted and does nothing.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \\
      --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import configs
from repro_torch.configs import shapes as shp
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.parallel import dtensor as D
from repro_torch.train import optimizer as opt
from repro_torch.train import tree as T

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# FSDP needed to fit the 1T model; the 15B dense also benefits.
FSDP_ARCHS = {"kimi-k2-1t-a32b", "nemotron-4-15b"}
REFUSED = {"block_q": "K4 fixes its own tiles",
           "block_k": "K4 fixes its own tiles",
           "scores_dtype": "K4 scores in float32"}


def device_type() -> str:
    """The mesh's and the fake tensors' device: CUDA where this build of
    PyTorch has it, else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on the ``fake`` backend, at rank 0;
    destroyed on exit (the default group is process-wide)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def state_bytes_per_device(*trees) -> float:
    """Bytes of this rank's shards of every tensor of ``trees`` (a tensor
    reached twice, as the cache's shared ``enc_len``, counts once)."""
    seen, total = set(), 0
    for tree in trees:
        for t in T.leaves(tree):
            if id(t) in seen:
                continue
            seen.add(id(t))
            local = t.to_local() if D.is_dt(t) else t
            total += local.numel() * local.element_size()
    return float(total)


def fake_params(model, device: str):
    """``model.init`` under the active ``FakeTensorMode``, each parameter
    then on ``device`` (the init's generator is a CPU one)."""
    params = model.init(torch.Generator())
    if device != "cpu":
        for mod in params.modules():
            if isinstance(mod, nn.ParameterDict):
                for k, p in list(mod.items()):
                    if isinstance(p, torch.Tensor):
                        mod[k] = nn.Parameter(
                            torch.empty_like(p, device=device),
                            requires_grad=False)
    return params


def _placed(batch, mesh, place, device: str):
    """Fake DTensors on ``device`` for the meta stand-ins of ``batch``,
    each placed by ``place[name]``, made from this rank's shard."""
    return {k: D.zeros_placed(v.shape, v.dtype, mesh, place[k], device)
            for k, v in batch.items()}


# ===================================================================== cells
def build_cell(arch: str, shape_name: str, mesh, fsdp: bool,
               overrides: Optional[dict] = None, manual_dp: bool = False,
               pure_dp: bool = False, device: Optional[str] = None):
    """Under the caller's ``FakeTensorMode``: (step, state trees, tokens,
    cfg, model, kind), where ``step()`` runs the cell's step once and the
    state trees are those ``analytic_state_bytes_per_device`` sums.
    ``overrides`` are ``ModelConfig`` field replacements; ``manual_dp``
    swaps in the int8-compressed explicit-DP train step."""
    from repro_torch.parallel import sharding as shlib
    from repro_torch.train.trainer import Trainer, TrainerConfig
    device = device or mesh.device_type
    cfg = configs.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg)
    kind, batch = shp.input_specs(cfg, shape_name, concrete=False)
    suite = shp.SHAPES[shape_name]
    params = fake_params(model, device)
    if kind == "train" and manual_dp:
        from repro_torch.train import manual_dp as mdp
        from repro_torch.train.trainer import place_state
        batch = {k: torch.empty_like(v, device=device)
                 for k, v in batch.items()}
        fn, (pplace, _, eplace, _) = mdp.build(model, mesh, opt.OptConfig(),
                                               batch)
        ost = place_state(params, opt.init(params.tree()), mesh, pplace)
        sizes = shlib.axis_sizes(mesh)
        n_shards = sizes.get("pod", 1) * sizes.get("data", 1)
        # this rank's rows of the error state, in the parameters' order
        err = [D.zeros_placed((n_shards,) + tuple(p.shape), torch.float32,
                              mesh, place, device)
               for p, place in zip(T.leaves(params.tree()),
                                   T.leaves_like(eplace, params.tree()))]

        def step():
            return fn(params, ost, err, batch)
        return (step, [params.tree(), ost.mu, ost.nu, err],
                suite.seq_len * suite.global_batch, cfg, model, kind)

    tr = Trainer(model, opt.OptConfig(), TrainerConfig(
        fsdp=fsdp, pure_dp=pure_dp), mesh=mesh)
    if kind == "train":
        ost = tr.place(params, opt.init(params.tree()))
        batch = _placed(batch, mesh, tr.batch_placements(batch), device)
        fn = tr.build_step(batch)

        def step():
            return fn(params, ost, batch)
        return (step, [params.tree(), ost.mu, ost.nu],
                suite.seq_len * suite.global_batch, cfg, model, kind)

    tr.place_params(params)
    bplace = {k: shlib.placements(s, mesh) for k, s in
              shlib.batch_shardings(batch, mesh).items()}
    if kind == "prefill":
        batch = _placed(batch, mesh, bplace, device)

        def step():
            with torch.no_grad():
                return model.prefill(params, batch, max_len=suite.seq_len)
        return (step, [params.tree()], suite.seq_len * suite.global_batch,
                cfg, model, kind)

    cache = model.init_cache(suite.global_batch, suite.seq_len, device,
                             mesh=mesh,
                             long_context=(shape_name == "long_500k"))
    tokens = _placed({"tokens": batch["tokens"]}, mesh, bplace,
                     device)["tokens"]
    pos = torch.empty_like(batch["pos"], device=device)

    def step():
        with torch.no_grad():
            logits, _ = model.decode_step(params, tokens, cache, pos)
            # the vocabulary gathered first: DTensor's argmax over a split
            # dim reads its shard offsets back from tensors, which fake
            # tensors cannot give
            return torch.argmax(D.unsplit(logits, -1), -1)
    return (step, [params.tree(), cache], suite.global_batch, cfg, model,
            kind)


# ===================================================================== run
def run_cell(arch: str, shape_name: str, mesh_name: str,
             fsdp: Optional[bool] = None, verbose: bool = True,
             overrides: Optional[dict] = None, variant: str = "",
             manual_dp: bool = False, pure_dp: bool = False) -> dict:
    """One cell's row, on a fake world of its size (started and destroyed
    here)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ok, reason = shp.cell_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    multi = mesh_name == "multipod"
    chips = 512 if multi else 256
    if fsdp is None:
        fsdp = arch in FSDP_ARCHS
    dev = device_type()
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi, device_type=dev)
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        t0 = time.time()
        with fake:
            step, state, tokens, cfg, model, kind = build_cell(
                arch, shape_name, mesh, fsdp, overrides,
                manual_dp=manual_dp, pure_dp=pure_dp, device=dev)
            with rf.CountingMode() as counts:
                step()
            t_trace = time.time() - t0
            analytic = state_bytes_per_device(*state)
    coll = dict(counts.collectives)
    flops, byt = float(counts.flops), float(counts.bytes)
    terms = rf.derive(arch, shape_name, mesh_name, chips, flops, byt,
                      float(coll["total"]), cfg, tokens,
                      bytes_per_device=analytic,
                      note="fsdp" if fsdp else "",
                      fwd_only=(kind != "train"))
    row = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips, "fsdp": fsdp, "kind": kind,
        "variant": variant, "overrides": overrides or {},
        "device": dev, "trace_s": round(t_trace, 2),
        "cost_analysis": {"flops": flops, "bytes accessed": byt},
        "probe": None,
        "memory_analysis": None,
        "analytic_state_bytes_per_device": analytic,
        "fits_h100_hbm_80g": bool(analytic < 80e9),
        "collectives": coll,
        "kernels": {k: v for k, v in counts.calls.items()
                    if k.startswith("repro::")},
        "roofline": terms.row(),
        "hlo_bytes": None,
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
              f"(trace {t_trace:.1f}s, "
              f"state/device {analytic/1e9:.2f} GB, "
              f"bottleneck {terms.bottleneck}, "
              f"useful {terms.useful_ratio:.2f})")
    return row


def cell_path(arch, shape, mesh_name, variant: str = "",
              out_dir: Optional[str] = None):
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    return os.path.join(out_dir,
                        f"{arch}__{shape}__{mesh_name}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--no-probe", action="store_true",
                    help="accepted; the port has no probe")
    ap.add_argument("--out", default=None,
                    help=f"row directory (default {OUT_DIR})")
    ap.add_argument("--variant", default="",
                    help="tag for <out>/<cell>__<variant>.json")
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "dots", "full"])
    ap.add_argument("--logits-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--block-q", type=int, default=None)
    ap.add_argument("--block-k", type=int, default=None)
    ap.add_argument("--pad-vocab", type=int, default=None)
    ap.add_argument("--scores-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--manual-dp-int8", action="store_true",
                    help="explicit DP with the int8 error-feedback mean")
    ap.add_argument("--ablate-mixer", action="store_true",
                    help="diagnostic: skip attention/ssm mixers")
    ap.add_argument("--pure-dp", action="store_true",
                    help="no-TP layout: batch over every axis + ZeRO-3")
    args = ap.parse_args(argv)
    for k, why in REFUSED.items():
        if getattr(args, k) is not None:
            ap.error(f"--{k.replace('_', '-')} is not a knob of the port: "
                     f"{why}")

    overrides = {}
    if args.remat is not None:
        overrides["remat"] = args.remat
    if args.logits_dtype is not None:
        overrides["logits_dtype"] = args.logits_dtype
    if args.capacity_factor is not None:
        overrides["moe_capacity_factor"] = args.capacity_factor
    if args.pad_vocab is not None:
        overrides["pad_vocab_multiple"] = args.pad_vocab
    if args.ablate_mixer:
        overrides["ablate_mixer"] = True

    archs = configs.ARCHS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(shp.SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    fsdp = None if args.fsdp is None else (args.fsdp == "on")

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                path = cell_path(arch, shape, mesh_name, args.variant,
                                 args.out)
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] cached: {path}")
                    continue
                try:
                    row = run_cell(arch, shape, mesh_name, fsdp=fsdp,
                                   overrides=overrides or None,
                                   variant=args.variant,
                                   manual_dp=args.manual_dp_int8,
                                   pure_dp=args.pure_dp)
                except Exception as e:                 # noqa: BLE001
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape,
                           "mesh": mesh_name, "status": "FAILED",
                           "variant": args.variant,
                           "error": str(e)[-2000:]}
                    failures.append((arch, shape, mesh_name))
                with open(path, "w") as f:
                    json.dump(row, f, indent=1)
    if failures:
        print("FAILED cells:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
