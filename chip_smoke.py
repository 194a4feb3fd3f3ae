#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA GPU, the
CUDA toolkit (nvcc) and PyTorch built for CUDA; it imports nothing of JAX
and nothing of the JAX package ``repro``.  Phases:

  1. the card's name and power limit; build every kernel from the
     checkout's sources (one nvcc per source, all started together);
  2. K1 (matcher) against its plain PyTorch version on the card, bit for
     bit: built-in and random rule tables over wire-correct and random
     frames, N = 64 and N = 65,536;
  3. K2 (DDT gather) against its plain version on the card, bit for bit:
     int32, float32 with -0.0 and NaN payloads, uint8; holes; sources up
     to 4 MiB;
  4. the main path: ``SpinNIC.step`` at the NIC's full geometry (512 KiB
     L2, 16 MPQ entries, batches of 64 frames) receiving 16 concurrent
     Fig 9 datatype messages (count 1024) over SLMP, for the complex and
     the simple datatype; host memory is checked against the MPI unpack
     oracle and the final state against the same stream run on the CPU;
     one ICMP echo batch; K1 launches once per step;
  5. ``SpinIngest`` on the card (vocab 32000, batch 8, seq 4096: a
     ~128 KiB message of ~89 frames), tokens checked against the corpus,
     K1 once and K2 twice per call; the Fig 10 overlap loops with a
     float32 matmul sized to outlast the ingest (R is printed, and only
     checked to lie in [0, 1]);
  6. kernel timings on the card (CUDA events, median of 25 runs of 20
     back-to-back calls queued behind a GPU spin, so that the events see
     device time only; the host's cost to issue a call is printed beside
     it), the least time the card could take (bytes moved over
     3.35 TB/s), the plain version's time and, for K2, ``torch.take``'s
     time as a yardstick;
  7. one NIC step under torch.profiler: kernels per step, device busy
     time and the idle share it implies.

Any failed check raises, so the script exits nonzero; it also exits
nonzero, printing no result, when CUDA is unavailable.  The last two lines
of standard output are the ``kernels`` JSON object and the result JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12             # non-tensor-core float32 peak, same sheet
FIG10_MSGS = 16                    # paper: 16 concurrent messages
FIG10_COUNT = 1024                 # Fig 9 datatypes at count 1024
NIC_BATCH = 64                     # SpinNIC default batch


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed ({r.returncode})"


def bits(t):
    import torch
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


SLEEP_CYCLES = 100_000_000      # GPU spin queued ahead of timed calls
SLEEP_S = SLEEP_CYCLES / 1.98e9    # its least duration (H100 max SM clock)


def time_ms(fn, runs=25, per_run=20):
    """Time ``fn`` on the card.  Returns ``(device_ms, host_ms)`` per call.

    device_ms: median over ``runs`` of (end - start) / ``per_run``, CUDA
    events around ``per_run`` back-to-back calls.  A GPU spin queued first
    holds the events back until the host has queued every call, so the
    events bracket device work only, not the host's launch cost.
    host_ms: median host time to issue one call (the wrapper's cost).
    Raises if issuing took most of the spin (the queue could have run
    dry, and device_ms would include host time).
    """
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        ts = time.perf_counter()
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(per_run):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        if t1 - ts > 0.8 * SLEEP_S:
            raise AssertionError("timing: issuing the calls outlasted the "
                                 "GPU spin")
        dev.append(a.elapsed_time(b) / per_run)
        host.append((t1 - t0) * 1e3 / per_run)
    return statistics.median(dev), statistics.median(host)


# ------------------------------------------------------------------ inputs
def wire_frames(n, seed):
    import numpy as np
    from repro_torch.core import packet as pkt
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(min(n, 256)):
        pay = rng.integers(0, 256, int(rng.integers(0, 200))).astype(np.uint8)
        frames.append([pkt.make_icmp_echo(pay, seq=i),
                       pkt.make_udp(pay, dport=9999),
                       pkt.make_slmp(i, 0, pkt.SLMP_FLAG_EOM, pay),
                       pkt.make_slmp(i, 1484, 0, pay, dport=9331),
                       pkt.make_udp(pay, dport=53)][i % 5])
    return np.resize(pkt.stack_frames_np(frames)[0], (n, pkt.MTU))


def rule_tables(seed):
    import numpy as np
    from repro_torch.core import matching as m
    from repro_torch.core import packet as pkt
    rs = [m.ruleset_icmp_echo(), m.ruleset_udp_pingpong(9999),
          m.ruleset_slmp(9330), m.ruleset_slmp(9331), m.ruleset_none()]
    yield "builtin", np.stack([r.as_array() for r in rs]), \
        np.array([r.mode for r in rs], np.int32)
    rng = np.random.default_rng(seed)
    rules = np.zeros((6, 4, 4), np.uint32)
    rules[..., 0] = rng.integers(0, pkt.WORDS, (6, 4))
    rules[..., 1] = rng.choice(np.array([0xFF, 0xFF00, 0xFFFF0000,
                                         0xFFFFFFFF, 0], np.uint32), (6, 4))
    rules[..., 2] = rng.integers(0, 2**31, (6, 4))
    rules[..., 3] = rules[..., 2] + rng.integers(0, 2**31, (6, 4))
    yield "random", rules, rng.integers(0, 2, 6).astype(np.int32)


# ------------------------------------------------------------------ phases
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({len(build.SOURCES)} sources, parallel nvcc)")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1]   {name}: {line.strip()}")


def phase_k1(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.matcher import ops, ref
    for n in (64, 65536):
        for kind in ("wire", "random"):
            data = wire_frames(n, n) if kind == "wire" else \
                np.random.default_rng(n).integers(0, 256, (n, 1536)
                                                  ).astype(np.uint8)
            d = torch.as_tensor(data, device=dev)
            for tname, rules, modes in rule_tables(n):
                r = torch.as_tensor(rules.astype(np.int64), device=dev)
                m = torch.as_tensor(modes, device=dev)
                got = ops.match(d, r, m)
                want = ref.match_ref(d, r, m)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"K1 mismatch n={n} {kind} {tname}")
                log(f"[2] K1 n={n} frames={kind} rules={tname}: bit-exact "
                    f"(matched {int(got[0].sum())}, eom {int(got[1].sum())})")


def phase_k2(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.ddt import ops, ref
    rng = np.random.default_rng(7)
    cases = [("int32", 1 << 20, 1 << 20), ("float32", 1 << 20, 3 << 19),
             ("uint8", 1 << 22, 1 << 21), ("float32", 1000, 77777),
             ("int32", 1, 10)]
    for dtype, s, i in cases:
        if dtype == "float32":
            src = rng.normal(size=s).astype(np.float32)
            src[::5] = -0.0
            src.view(np.uint32)[1::7] = 0x7FC01234          # NaN payloads
            fill = -0.0
        elif dtype == "int32":
            src = rng.integers(-2**31, 2**31, s).astype(np.int32)
            fill = -7
        else:
            src = rng.integers(0, 256, s).astype(np.uint8)
            fill = 0xAB
        idx = rng.integers(-1, s + s // 50 + 2, i).astype(np.int32)
        ts = torch.as_tensor(src, device=dev)
        ti = torch.as_tensor(idx, device=dev)
        got = ops.gather(ts, ti, fill=fill)
        want = ref.ddt_gather_ref(ts, ti, fill)
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"K2 mismatch {dtype} S={s} I={i}")
        log(f"[3] K2 {dtype} S={s} ({src.nbytes} B) I={i}: bit-exact "
            f"(holes {int((idx < 0).sum())}, idx>=S {int((idx >= s).sum())})")


def fig10_stream(kind, dev, seed=0):
    """16 messages of the Fig 9 datatype, interleaved one frame per
    message, through SpinNIC.step at full geometry.  Returns (nic, state,
    committed, msgs, egress rows per step, seconds per step)."""
    import numpy as np
    import torch
    from repro_torch.core import apps, ddt, packet as pkt, slmp, spin_nic
    base = ddt.complex_ddt() if kind == "complex" else ddt.simple_ddt()
    c = ddt.commit(base, count=FIG10_COUNT)
    rng = np.random.default_rng(seed)
    msgs = [ddt.pack_np(c, rng.integers(0, 256, c.mem_bytes
                                        ).astype(np.uint8))
            for _ in range(FIG10_MSGS)]
    cfg = slmp.SlmpSenderConfig(window=1, port=9331)
    lists = [slmp.segment_message(m, i, cfg) for i, m in enumerate(msgs)]
    frames = [f for grp in zip(*lists) for f in grp]
    ctx = apps.make_ddt_context(c, msgs_in_flight=FIG10_MSGS, device=dev)
    nic = spin_nic.SpinNIC([ctx], host_bytes=FIG10_MSGS * c.mem_bytes,
                           batch=NIC_BATCH, device=dev)
    st = nic.init_state()
    batches = [pkt.stack_frames_np(frames[k:k + NIC_BATCH], n=NIC_BATCH)
               for k in range(0, len(frames), NIC_BATCH)]
    egress, secs = [], []
    for b in batches:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, eg, _ = nic.step(st, pkt.PacketBatch.from_numpy(*b, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        egress.append(eg.numpy())
    return nic, st, c, msgs, egress, secs, len(frames)


def profile_step(step_fn):
    """One call of ``step_fn`` under torch.profiler.  Returns (device
    kernels, device busy us as the union of kernel intervals, wall us on
    the host clock, the three commonest kernel names).  The profiler
    slows the host, so the idle share it implies is an upper estimate."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur:
        busy += cur[1] - cur[0]
    names = collections.Counter(e.name for e in evs).most_common(3)
    return len(spans), busy, wall, names


def phase_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.core import apps, ddt, packet as pkt, slmp, spin_nic
    from repro_torch.kernels.matcher import ops as k1
    steps_total = 0
    for kind in ("complex", "simple"):
        before = k1.launches
        nic, st, c, msgs, egress, secs, nframes = fig10_stream(kind, dev)
        steps = len(secs)
        if k1.launches - before != steps:
            raise AssertionError(f"K1 ran {k1.launches - before} times in "
                                 f"{steps} steps")
        steps_total += steps
        if kind == "complex":
            # kept to profile one more step at the end of the run
            replay = (nic, st.clone(), pkt.stack_frames(
                [f for grp in zip(*[slmp.segment_message(
                    m, i, slmp.SlmpSenderConfig(window=1, port=9331))
                    for i, m in enumerate(msgs)]) for f in grp][:NIC_BATCH],
                n=NIC_BATCH, device=dev))
        for i, m in enumerate(msgs):
            want = ddt.unpack_np(c, m, np.zeros(c.mem_bytes, np.uint8))
            got = nic.read_host(st, (i % FIG10_MSGS) * c.mem_bytes,
                                c.mem_bytes)
            if not np.array_equal(got, want):
                raise AssertionError(f"{kind}: host region {i} != unpack")
        acks = sum(len(slmp.parse_acks(e)) for e in egress)
        if acks != nframes:
            raise AssertionError(f"{kind}: {acks} ACKs for {nframes} frames")
        done, st = nic.pop_counters(st, slmp.COMPLETION_QUEUE)
        if sorted(done.tolist()) != list(range(FIG10_MSGS)):
            raise AssertionError(f"{kind}: completions {done.tolist()}")
        if int(st.dropped) or int(st.mpq.evictions):
            raise AssertionError(f"{kind}: drops or MPQ evictions")
        # the same stream on the CPU must end in a bitwise-equal state
        cnic, cst, *_, cegress, _, _ = fig10_stream(kind, torch.device("cpu"))
        _, cst = cnic.pop_counters(cst, slmp.COMPLETION_QUEUE)
        gd, cd = st.to_numpy(), cst.to_numpy()
        for key in cd:
            if not np.array_equal(gd[key], cd[key]):
                raise AssertionError(f"{kind}: CUDA/CPU state differs: {key}")
        for e1, e2 in zip(egress, cegress):
            for a, b in zip(e1, e2):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{kind}: CUDA/CPU egress differs")
        share = (len(secs) - 1) / len(secs)   # traffic after step 1
        log(f"[4] Fig10 {kind}: {FIG10_MSGS} msgs x {c.msg_bytes} B "
            f"({nframes} frames, {len(secs)} steps of {NIC_BATCH}): host "
            f"== unpack oracle, {acks} ACKs, CUDA state == CPU state; "
            f"step median {statistics.median(secs[1:]) * 1e3:.3f} ms, "
            f"first {secs[0] * 1e3:.1f} ms (host clock, synchronized); "
            f"{nframes * share / sum(secs[1:]):.0f} frames/s and "
            f"{FIG10_MSGS * c.msg_bytes * share / sum(secs[1:]) / 1e6:.2f} "
            f"MB/s of message after the first step")

    # one ICMP echo batch: the reply checksum must verify
    before = k1.launches
    nic = spin_nic.SpinNIC([apps.make_icmp_context(),
                            apps.make_udp_pingpong_context()],
                           batch=NIC_BATCH, device=dev)
    frames = [pkt.make_icmp_echo(np.arange(n, dtype=np.uint8) * 3, seq=n)
              for n in (1, 56, 63, 1000)]
    _, eg, _ = nic.step(nic.init_state(),
                        pkt.stack_frames(frames, n=NIC_BATCH, device=dev))
    data, length, valid = eg.numpy()
    if valid.sum() != len(frames):
        raise AssertionError("ICMP: missing replies")
    for f, ln in zip(data[valid], length[valid]):
        if f[pkt.ICMP_TYPE] != pkt.ICMP_ECHO_REPLY or \
                pkt.internet_checksum_np(f[pkt.L4_BASE:ln]) != 0:
            raise AssertionError("ICMP: bad reply")
    if k1.launches - before != 1:
        raise AssertionError("ICMP step did not launch K1 once")
    steps_total += 1
    log(f"[4] ICMP echo: {len(frames)} replies, checksums verify")
    return steps_total, replay


def phase_ingest(dev):
    """SpinIngest checks and the Fig 10 overlap loops.  Returns the
    ingest, one raw feed and the number of ingest calls made."""
    import numpy as np
    import torch
    from repro_torch.core import overlap
    from repro_torch.kernels.ddt import ops as k2
    from repro_torch.kernels.matcher import ops as k1
    from repro_torch.train import data as tdata
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = tdata.PacketizedPipeline(vocab=32000, batch=8, seq=4096)
    spin = tdata.SpinIngest(pipe, device=dev)
    calls = 0

    def ingest(raw):
        nonlocal calls
        calls += 1
        return spin(raw)

    feeds = [pipe.packets_for_step(i) for i in range(12)]
    m0, g0 = k1.launches, k2.launches
    for i in range(3):
        out = ingest(feeds[i])
        want = pipe.corpus.batch(i, pipe.batch, pipe.seq)
        if not (np.array_equal(out["tokens"].cpu().numpy(), want[:, :-1])
                and np.array_equal(out["targets"].cpu().numpy(),
                                   want[:, 1:])):
            raise AssertionError(f"SpinIngest tokens wrong at step {i}")
    if (k1.launches - m0, k2.launches - g0) != (3, 6):
        raise AssertionError(f"SpinIngest launches K1={k1.launches - m0} "
                             f"K2={k2.launches - g0} for 3 calls")
    log(f"[5] SpinIngest: message {pipe.msg_bytes} B in {pipe.n_packets} "
        f"frames -> tokens (8, 4096) == corpus; launches per call: K1 1, "
        f"K2 2")

    # size the compute to outlast the ingest (bench_ddt.py's method)
    t_ing = []
    for f in feeds[:5]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ingest(f)
        torch.cuda.synchronize()
        t_ing.append(time.perf_counter() - t0)
    t_ingest = statistics.median(t_ing)
    g = torch.Generator(device=dev).manual_seed(0)
    dim = 8192
    for cand in (512, 1024, 1536, 2048, 3072, 4096, 6144, 8192):
        a = torch.randn((cand, cand), device=dev, generator=g)
        a @ a
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a @ a
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= 1.2 * t_ingest:
            dim = cand
            break
    w = torch.randn((dim, dim), device=dev, generator=g)

    def compute(state, batch):
        return state @ w / dim

    s0 = torch.eye(dim, device=dev)
    _, seq = overlap.sequential_loop(ingest, compute, feeds, s0, device=dev)
    _, ovl = overlap.overlapped_loop(ingest, compute, feeds, s0, device=dev)
    for rep in (seq, ovl):
        if not 0.0 <= rep.overlap_ratio <= 1.0:
            raise AssertionError(f"R out of range: {rep.row()}")
    log(f"[5] ingest {t_ingest * 1e3:.3f} ms per call (host clock, incl. "
        f"H2D copy of the frames); compute: float32 matmul dim {dim}")
    log(f"[5] sequential: {seq.row()} wall={seq.wall_s * 1e3:.2f}ms")
    log(f"[5] overlapped: {ovl.row()} wall={ovl.wall_s * 1e3:.2f}ms")
    return spin, feeds[0], calls


def phase_kernels(dev, launches, spin):
    """Time K1 and K2 at the main path's shapes.  Returns the entries of
    the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.core import matching, packet as pkt
    from repro_torch.kernels.ddt import ops as k2, ref as k2ref
    from repro_torch.kernels.matcher import ops as k1, ref as k1ref
    out = []

    # K1 at the main path's shape (a batch of 64 frames, the Fig 10 NIC's
    # single context), and at 65,536 frames of three contexts
    for n, ctxs in ((NIC_BATCH, [matching.ruleset_slmp(9331)]),
                    (65536, [matching.ruleset_icmp_echo(),
                             matching.ruleset_udp_pingpong(),
                             matching.ruleset_slmp(9330)])):
        tables = matching.MatchTables.build(ctxs, device=dev)
        d = torch.as_tensor(wire_frames(n, n + 1), device=dev)
        nctx = tables.n_ctx
        words = torch.unique(torch.clamp(
            tables.rules[:, :, 0], 0, pkt.WORDS - 1)).numel()
        nbytes = n * words * 4 + tables.rules.numel() * 8 + nctx * 4 \
            + 2 * n * nctx
        n_ops = n * nctx * 4 * 4         # per rule: mask, 2 compares, combine
        got = k1.match(d, tables.rules, tables.modes)
        want = k1ref.match_ref(d, tables.rules, tables.modes)
        err = max(int((got[i] != want[i]).sum()) for i in (0, 1))
        if err:
            raise AssertionError("K1 mismatch at the timed shape")
        ms, host = time_ms(lambda: k1.match(d, tables.rules, tables.modes))
        plain, phost = time_ms(lambda: k1ref.match_ref(d, tables.rules,
                                                       tables.modes))
        bound = max(nbytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
        log(f"[6] K1 N={n} C={nctx}: device {ms * 1e3:.3f} us (wrapper "
            f"issues a call in {host * 1e3:.2f} us), plain device "
            f"{plain * 1e3:.3f} us (issued in {phost * 1e3:.2f} us), bound "
            f"{bound * 1e6:.2f} ns ({nbytes} B, {n_ops} int ops)")
        if n == NIC_BATCH:
            out.append(dict(
                name="match", route="cuda",
                source="src/repro_torch/kernels/matcher/matcher.cu",
                replaces="src/repro/kernels/matcher/matcher.py:62",
                launches=launches["match"], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=None))

    # K2 at the main path's shapes: SpinIngest's unpack gather (message
    # elements -> application buffer) and token gather (buffer -> tokens)
    rng = np.random.default_rng(11)
    entry = None
    for name, idx in (("unpack", spin.unpack_idx), ("tokens", spin.pack_idx)):
        s = (spin.pl.msg_bytes // 4 if name == "unpack"
             else spin.pl.mem_elems)
        src = torch.as_tensor(rng.integers(-2**31, 2**31, s).astype(
            np.int32), device=dev)
        got = k2.gather(src, idx)
        want = k2ref.ddt_gather_ref(src, idx)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise AssertionError("K2 mismatch at the timed shape")
        used = torch.unique(idx[idx >= 0].clamp(max=s - 1)).numel()
        nbytes = idx.numel() * 4 * 2 + used * 4
        safe = idx.clamp(0, s - 1).to(torch.int64)     # take wants int64
        ms, host = time_ms(lambda: k2.gather(src, idx))
        plain, phost = time_ms(lambda: k2ref.ddt_gather_ref(src, idx))
        lib, _ = time_ms(lambda: torch.take(src, safe))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[6] K2 {name} S={s} I={idx.numel()}: device "
            f"{ms * 1e3:.3f} us (wrapper issues a call in "
            f"{host * 1e3:.2f} us), plain device {plain * 1e3:.3f} us "
            f"(issued in {phost * 1e3:.2f} us), torch.take "
            f"{lib * 1e3:.3f} us, bound {bound * 1e6:.2f} ns ({nbytes} B)")
        if entry is None:
            entry = dict(
                name="ddt_gather", route="cuda",
                source="src/repro_torch/kernels/ddt/ddt_gather.cu",
                replaces="src/repro/kernels/ddt/ddt.py:71",
                launches=launches["ddt_gather"], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=lib)
    out.append(entry)
    # K2 on a 4 MiB int32 permutation, for the record
    src = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    idx = torch.randperm(1 << 20, device=dev).to(torch.int32)
    ms, _ = time_ms(lambda: k2.gather(src, idx))
    idx64 = idx.to(torch.int64)
    lib, _ = time_ms(lambda: torch.take(src, idx64))
    bound = (3 * 4 << 20) / HBM_BYTES_PER_S * 1e3
    log(f"[6] K2 permutation S=I=1048576 int32: device {ms * 1e3:.3f} us, "
        f"torch.take {lib * 1e3:.3f} us, bound {bound * 1e3:.3f} us")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels.ddt import ops as k2   # fails outside a checkout
    from repro_torch.kernels.matcher import ops as k1
    dev = torch.device("cuda")
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    phase_build()
    phase_k1(dev)
    phase_k2(dev)
    # the main path: launches are counted from here to the end of phase 5
    k1.launches = k2.launches = 0
    steps, replay = phase_main_path(dev)
    spin, raw, calls = phase_ingest(dev)
    launches = {"match": k1.launches, "ddt_gather": k2.launches}
    log(f"[5] main-path launches: K1 {launches['match']} (= {steps} NIC "
        f"steps + {calls} ingest calls), K2 {launches['ddt_gather']} "
        f"(= 2 x {calls} ingest calls)")
    if launches != {"match": steps + calls, "ddt_gather": 2 * calls}:
        raise AssertionError(f"main path launches {launches}")
    kernels = phase_kernels(dev, launches, spin)
    # last, because the profiler's tracing may slow later launches: one
    # Fig 10 step (the complex stream's first batch, replayed) profiled
    nic, st, batch = replay
    n_k, busy, wall, names = profile_step(lambda: nic.step(st, batch))
    log(f"[7] profiled NIC step: {n_k} device kernels, device busy "
        f"{busy:.1f} us of {wall:.1f} us wall (idle share "
        f"{1 - busy / wall:.3f}, profiler on); commonest "
        f"{[(n[:60], c) for n, c in names]}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
