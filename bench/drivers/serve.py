"""The serving cell: ``repro_torch.serve.engine.ServeEngine.prefill`` then
``ServeEngine.step``, greedy, one client with a full queue.

Traffic: batches of ``batch`` prompts of ``prompt`` tokens, drawn per
batch from the seed (uniform over the vocabulary), each served
``generate`` tokens (the first from the prefill); batches run back to
back until ``seconds`` have passed, and the client reads each batch's
tokens when it ends.  The weights are made by the benchmark from the seed
(``bench/ref/mamba2.make_weights``) and copied into the program's
parameters.

What is checked, once the window has closed and the program is freed: a
sample of the finished requests, drawn from the seed, is run through the
plain float32 mamba2 (``bench/ref/mamba2``) over its prompt and its served
tokens.  Compared with their limits: the widest gap by which a served
token's logit lies below the reference's best at its position; the
largest gap between the program's logits and the reference's at the
prefill's position and at the last decode step's (the program's logits
are kept as the timed path returns them); each gap in units of the
reference logits' standard deviation at that position; and the prompts
sent whose answers the client did not get.
"""
from __future__ import annotations

import time

import numpy as np

from bench import harness as H
from bench import program
from bench.ref import flops, mamba2 as R


def _plant(plant, engine):
    """Faults put under the timed path (tests): a served token altered
    where it is produced; the step returning its state unchanged (the
    cache and the position not advanced); half the batch left out."""
    step = engine.step
    if "altered_answer" in plant:
        def altered(state):
            import torch
            nxt, st = step(state)
            if st.pos % 4 == 0:
                with torch.inference_mode():
                    nxt.add_(1).remainder_(engine.model.cfg.vocab)
            return nxt, st
        engine.step = altered
    if "state_unchanged" in plant:
        def unchanged(state):
            import torch
            with torch.inference_mode():
                keep = [{k: v.clone() for k, v in c.items()}
                        for c in state.cache]
            nxt, st = step(state)
            with torch.inference_mode():
                for c, k in zip(st.cache, keep):
                    for name, v in k.items():
                        c[name].copy_(v)
            st.last_tokens = state.last_tokens
            return nxt, st
        engine.step = unchanged
    if "half_batch" in plant:
        prefill = engine.prefill

        def half(batch):
            n = batch["tokens"].shape[0] // 2
            st = prefill({k: v[:n] for k, v in batch.items()})
            return st
        engine.prefill = half


def _keep_logits(model, kept: dict) -> None:
    """Keep the logits the program's prefill and decode step return, as
    they return them, in ``kept`` (the latest of each)."""
    prefill, decode = model.prefill, model.decode_step

    def prefill_kept(*a, **k):
        out = prefill(*a, **k)
        kept["prefill"] = out[0]
        return out

    def decode_kept(*a, **k):
        out = decode(*a, **k)
        kept["decode"] = out[0]
        return out
    model.prefill, model.decode_step = prefill_kept, decode_kept


def run(cell: H.Cell) -> H.Outcome:
    import torch
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
    program.load_weights(params, R.make_weights(m, cell.seed, dev))
    engine = ServeEngine(model, params, max_len=plen + gen)
    kept = {}
    _keep_logits(model, kept)
    _plant(cell.plant, engine)
    rng = np.random.default_rng(cell.seed)
    pool = rng.integers(0, m["vocab"], size=(traffic["prompt_batches"], bsz,
                                             plen)).astype(np.int32)
    prompts = torch.as_tensor(pool, device=dev)
    marks.mark("weights and prompts")
    # warm-up: one prefill and a few decode steps of this shape
    st = engine.prefill({"tokens": prompts[-1]})
    for _ in range(3):
        _, st = engine.step(st)
    H.sync(dev)
    del st
    marks.mark("warm-up")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - cell.t0

    served, prefill_ms, decode_ms = [], [], []
    tokens = prompt_tokens = unanswered = 0
    w0 = time.perf_counter()
    b, done = 0, False
    while not done:
        H.sync(dev)
        t0 = time.perf_counter()
        st = engine.prefill({"tokens": prompts[b % len(prompts)]})
        H.sync(dev)
        t1 = time.perf_counter()
        prefill_ms.append((t1 - t0) * 1e3)
        prompt_tokens += bsz * plen
        out = [st.last_tokens]
        tokens += st.last_tokens.shape[0]
        for _ in range(gen - 1):
            nxt, st = engine.step(st)
            out.append(nxt)
            tokens += nxt.shape[0]
            if time.perf_counter() - w0 >= cell.seconds:
                done = True
                break
        got = torch.cat(out, dim=1).cpu().numpy()     # the client reads
        t2 = time.perf_counter()
        unanswered += bsz - got.shape[0]
        if got.shape[1] == gen:
            decode_ms.append((t2 - t1) * 1e3 / (gen - 1))
            served.append((b % len(prompts), got, kept["prefill"],
                           kept["decode"]))
        b += 1
    window_s = time.perf_counter() - w0
    decode_tokens = tokens - bsz * len(prefill_ms)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    readings = {
        "setup_s": setup_s, "window_s": window_s, "serve_tokens": tokens,
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "serve_flops": prompt_tokens * flops.forward_per_token(m)
        + decode_tokens * flops.decode_per_token(m)}
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
        del st

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
    del engine, params, model, served, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    marks.mark("window done, program freed")
    w = {k: v.float() for k, v in R.make_weights(m, cell.seed, dev).items()}
    gap = first_gap = last_gap = 0.0
    bad_tokens = 0
    with torch.no_grad():
        for p_idx, r, got, first, last in sampled:
            out_tok = torch.as_tensor(got, device=dev, dtype=torch.int64)
            if not ((out_tok >= 0) & (out_tok < m["vocab"])).all():
                bad_tokens += 1
                continue
            seqn = torch.cat([prompts[p_idx, r].long(), out_tok[:-1]])
            logits = R.forward(w, m, seqn[None])[0, plen - 1:]
            best = logits.max(dim=-1).values
            if "control_fp8" in cell.plant:
                # the control: the reference with float8 products; its
                # logits at each position, and the token it puts first
                ctl = R.forward(w, m, seqn[None], mm=R.fp8_matmul)[
                    0, plen - 1:]
                out_tok, first, last = ctl.argmax(dim=-1), ctl[0], ctl[-1]
            # every gap in units of the reference's spread of logits at
            # its position (its standard deviation over the vocabulary)
            unit = logits.std(dim=-1)
            mine = logits.gather(-1, out_tok[:, None])[:, 0]
            gap = max(gap, float(((best - mine) / unit).max()))
            first_gap = max(first_gap, float(
                (first.float() - logits[0]).abs().max() / unit[0]))
            last_gap = max(last_gap, float(
                (last.float() - logits[-1]).abs().max() / unit[-1]))
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
