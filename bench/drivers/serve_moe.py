"""The MoE serving cell: ``repro_torch.serve.engine.ServeEngine.prefill``
then ``ServeEngine.step``, greedy, one client with a full queue, on
Qwen1.5-MoE-A2.7B as published (``bench/ref/qwen2_moe``).

Traffic and loop are the serving cell's (``bench/drivers/serve.py``):
batches of ``batch`` prompts of ``prompt`` tokens, drawn per batch from
the seed (uniform over the vocabulary), each served ``generate`` tokens
(the first from the prefill), back to back until ``seconds`` have passed;
the client reads each batch's tokens when it ends; the window closes at
the first decode step past ``seconds`` once a batch has been served.  The
engine serves as a deployment on one card would, with its decode steps
replayed as a CUDA graph (``ServeEngine(cuda_graph=True)``; on the CPU it
runs them eagerly).  The weights are made by the benchmark from the seed,
one leaf at a time, and copied into the program's parameters as they are
made (30 GB: two whole copies at once would crowd the card).

A traced run profiles ``traced_decode_steps`` decode steps for the
harness's trace, then runs as many again under a profiler of its own
for K6, the grouped expert kernel: its device time, and the count of
experts that got a row, which K6 adds up on the device and which is
read once after that stretch.  ``moe.k6_roofline_share`` is K6's bound
(``bench/ref/qwen2_moe.k6_bound_s``) over that time, and
``moe.experts_ms_per_decode_step`` that time per decode step.

What is checked is the serving cell's comparison: a sample of finished
requests, drawn from the seed, run through the plain float32 reference
over prompt and served tokens, once the window has closed and the
program is freed; the served tokens' logit gap, the prefill's and the
last decode step's logits, each in units of the reference's deviation
at its position; tokens out of the vocabulary; prompts unanswered.

Plants (tests and ``bench/control.py``): ``control_fp8`` (the reference
with float8 products in the program's place), and three faults of the
published routing, each put in by changing the program's configuration:
``renormalised_topk`` (the top-4 weights renormalised to sum 1),
``shared_gate_off`` (the shared expert ungated) and
``dropped_assignments`` (the prefill at capacity factor 1.25, which drops
the assignments past an expert's capacity).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from bench import harness as H
from bench import program, program_trace
from bench.ref import qwen2_moe as R

FAULTS = {"renormalised_topk": dict(moe_norm_topk=True),
          "shared_gate_off": dict(moe_shared_gate=False)}


def _plant(plant, model) -> None:
    """The configuration faults, on the program's model."""
    for name, change in FAULTS.items():
        if name in plant:
            model.cfg = dataclasses.replace(model.cfg, **change)
    if "dropped_assignments" in plant:
        prefill, cfg = model.prefill, model.cfg
        capped = dataclasses.replace(cfg, moe_dropless=False,
                                     moe_capacity_factor=1.25)

        def dropping(*a, **k):
            model.cfg = capped
            try:
                return prefill(*a, **k)
            finally:
                model.cfg = cfg
        model.prefill = dropping


def _load(params, weights) -> None:
    """Copy each (name, tensor) of ``weights`` into the program's leaf of
    that name as it comes (same names, shapes and dtypes, or an error)."""
    import torch
    mine = dict(program.leaves(params.tree()))
    seen = set()
    with torch.no_grad():
        for k, w in weights:
            p = mine.get(k)
            if p is None or p.shape != w.shape or p.dtype != w.dtype:
                raise ValueError(f"{k}: program "
                                 f"{None if p is None else tuple(p.shape)}, "
                                 f"weights {tuple(w.shape)} {w.dtype}")
            p.copy_(w)
            seen.add(k)
    if seen != set(mine):
        raise ValueError(f"leaves without weights: "
                         f"{sorted(set(mine) - seen)[:8]}")


def _k6_pass(engine, prompt, steps: int, dev):
    """``steps`` decode steps after a prefill of ``prompt``, under a
    profiler: (K6's device seconds, its calls, rows a call, active
    experts).  On the CPU its time is that of the custom op's plain
    loop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import trace
    from repro_torch.kernels.moe_experts import ops as K6
    st = engine.prefill({"tokens": prompt})
    H.sync(dev)
    K6.reset_active(dev)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(steps):
            _, st = engine.step(st)
        H.sync(dev)
    trace.collect()                       # this stretch's spans: not read
    active = K6.active_experts(dev)
    if dev.type == "cuda":
        # a graph's replay runs its kernels without the wrapper: counted
        # from the profile, two kernels a call
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and any(k in e.name for k in K6.KERNELS)]
        n_calls = len(evs) // len(K6.KERNELS)
    else:
        evs = [e for e in prof.events() if e.name == "repro::moe_experts"]
        n_calls = len(evs)
    secs = sum(e.time_range.end - e.time_range.start for e in evs) * 1e-6
    rows_per_call = st.last_tokens.shape[0] * engine.model.cfg.top_k
    return secs, n_calls, rows_per_call, active


def run(cell: H.Cell) -> H.Outcome:
    import torch
    from repro_torch.kernels.flash_attention import ops as K4
    from repro_torch.kernels.moe_experts import ops as K6
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    marks = H.Stages(cell.t0)
    marks.mark("imports")
    dev, m = cell.device, cell.config["model"]
    traffic, limits = cell.workload["traffic"], cell.workload["limits"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bsz, plen, gen = traffic["batch"], traffic["prompt"], traffic["generate"]
    model = build_model(program.model_config(m))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _load(params, R.iter_weights(m, cell.seed, dev))
    engine = ServeEngine(model, params, max_len=plen + gen, cuda_graph=True)
    _plant(cell.plant, model)
    rng = np.random.default_rng(cell.seed)
    pool = rng.integers(0, m["vocab"], size=(traffic["prompt_batches"], bsz,
                                             plen)).astype(np.int32)
    prompts = torch.as_tensor(pool, device=dev)
    marks.mark("weights and prompts")
    # warm-up: one prefill and a few eager decode steps of this shape, with
    # the launches of K4 and K6 they made (on the card), then the decode
    # graph's capture and a replay
    k4, k6 = K4.launches, K6.launches
    st = engine.prefill({"tokens": prompts[-1]})
    diag = {"k4_per_prefill": K4.launches - k4,
            "k6_per_prefill": K6.launches - k6}
    k6 = K6.launches
    engine.cuda_graph = False
    for _ in range(3):
        _, st = engine.step(st)
    diag["k6_per_decode_step"] = (K6.launches - k6) / 3
    engine.cuda_graph = True
    for _ in range(2):
        _, st = engine.step(st)
    H.sync(dev)
    del st
    marks.mark("warm-up")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - cell.t0

    served, prefill_ms, decode_ms = [], [], []
    tokens = unanswered = 0
    flops = 0.0
    w0 = time.perf_counter()
    b, done = 0, False
    while not done:
        H.sync(dev)
        t0 = time.perf_counter()
        st = engine.prefill({"tokens": prompts[b % len(prompts)]})
        H.sync(dev)
        t1 = time.perf_counter()
        prefill_ms.append((t1 - t0) * 1e3)
        flops += R.prefill_flops(m, bsz, plen)
        first = st.logits
        out = [st.last_tokens]
        tokens += st.last_tokens.shape[0]
        for _ in range(gen - 1):
            pos = st.pos
            nxt, st = engine.step(st)
            flops += R.decode_flops(m, bsz, pos)
            out.append(nxt)
            tokens += nxt.shape[0]
            if served and time.perf_counter() - w0 >= cell.seconds:
                done = True
                break
        got = torch.cat(out, dim=1).cpu().numpy()     # the client reads
        t2 = time.perf_counter()
        unanswered += bsz - got.shape[0]
        if got.shape[1] == gen:
            decode_ms.append((t2 - t1) * 1e3 / (gen - 1))
            served.append((b % len(prompts), got, first, st.logits))
        b += 1
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    readings = {
        "setup_s": setup_s, "window_s": window_s, "serve_tokens": tokens,
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "serve_flops": flops, "diag": diag}
    trace = None
    if cell.trace:
        n_dec = min(traffic["traced_decode_steps"], gen - 1)
        st = engine.prefill({"tokens": prompts[0]})

        def traced():
            nonlocal st
            for _ in range(n_dec):
                with H.label("serve.decode", True):
                    _, st = engine.step(st)
        trace = H.profile(traced, dev)
        readings.update(trace=trace, traced_decode_steps=n_dec)
        program_trace.summary(readings)       # this stretch's spans
        del st
        secs, calls, rows, active = _k6_pass(engine, prompts[0], n_dec, dev)
        readings["k6"] = {"device_s": secs, "calls": calls, "steps": n_dec,
                          "rows": rows * calls, "active_experts": active,
                          "bound_s": R.k6_bound_s(m, rows * calls, active)}

    # ------------------------------------------------------------ checks
    reqs = [(i, r) for i, (_, got, _, _) in enumerate(served)
            for r in range(got.shape[0])]
    pick = rng.choice(len(reqs), size=min(traffic["checked_requests"],
                                          len(reqs)), replace=False)
    # the sampled requests' logits, as the program returned them
    sampled = []
    for j in pick:
        i, r = reqs[j]
        p_idx, got, first, last = served[i]
        sampled.append((p_idx, r, got[r], first[r].clone(), last[r].clone()))
    st = None
    del engine, params, model, served
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    marks.mark("window done, program freed")
    gap = first_gap = last_gap = 0.0
    fine = [s for s in sampled
            if ((s[2] >= 0) & (s[2] < m["vocab"])).all()]
    bad_tokens = len(sampled) - len(fine)
    if fine:
        w = R.make_weights(m, cell.seed, dev)
        with torch.no_grad():
            seqs = torch.stack([torch.cat([
                prompts[p_idx, r].long(),
                torch.as_tensor(got[:-1], device=dev, dtype=torch.int64)])
                for p_idx, r, got, _, _ in fine])
            logits = R.forward(w, m, seqs, first=plen - 1)
            mm = R.fp8_matmul if "control_fp8" in cell.plant else None
            ctl = None if mm is None else \
                R.forward(w, m, seqs, mm=mm, first=plen - 1)
            del w
            for n, (_, _, got, first, last) in enumerate(fine):
                out_tok = torch.as_tensor(got, device=dev,
                                          dtype=torch.int64)
                ref = logits[n]
                if ctl is not None:
                    # the control: the reference with float8 products; its
                    # logits at each position, and the token it puts first
                    out_tok, first, last = ctl[n].argmax(dim=-1), \
                        ctl[n][0], ctl[n][-1]
                best = ref.max(dim=-1).values
                # every gap in units of the reference's spread of logits
                # at its position (its standard deviation over the
                # vocabulary)
                unit = ref.std(dim=-1)
                mine = ref.gather(-1, out_tok[:, None])[:, 0]
                gap = max(gap, float(((best - mine) / unit).max()))
                first_gap = max(first_gap, float(
                    (first.float() - ref[0]).abs().max() / unit[0]))
                last_gap = max(last_gap, float(
                    (last.float() - ref[-1]).abs().max() / unit[-1]))
    marks.mark("reference")
    checks = [H.Check("served_logit_gap", gap, limits["served_logit_gap"]),
              H.Check("prefill_logit_gap", first_gap,
                      limits["prefill_logit_gap"]),
              H.Check("last_step_logit_gap", last_gap,
                      limits["last_step_logit_gap"]),
              H.Check("served_tokens_out_of_vocab", float(bad_tokens), 0.0),
              H.Check("requests_unanswered", float(unanswered), 0.0)]
    if not reqs:
        checks.append(H.Check("finished_requests", 0.0, -1.0))
    return H.Outcome(readings=readings, checks=checks,
                     attempted=len(reqs) + unanswered,
                     failed=bad_tokens + unanswered,
                     memory_peak_bytes=int(peak),
                     trace=trace)
