"""The NIC cell: SLMP messages of an MPI datatype received by
``repro_torch.core.spin_nic.SpinNIC.step`` with the ``mpi_ddt`` context.

Traffic (the workload's ``traffic``): ``messages`` messages in flight, one
frame of each in turn (the paper's interleaving), in rounds of fresh
message ids that follow each other back to back on the wire.  A message
is random bytes (the sender's buffer is contiguous, a matching type
signature), so where the datatype's blocks overlap the bytes differ and
only the last write gives the reference.  The frames of ``rounds_staged``
rounds are made at set-up from the seed (the benchmark's own SLMP
framing, ``bench/ref``) and staged on the device; the stream replays them, ``batch`` frames a step.  Round r
lands in receive buffers ``(r % 2) * messages + i`` (the host posts two
sets, so a round is read while the next one lands).  The host polls the
completion FIFO after every step, as the paper's host does.

The window runs steps until ``seconds`` have passed; the stream then
drains (untimed) until every message that had begun has completed.  What
is checked, every number with limit 0: each message's completion comes
once, at the step of its last frame; each round's receive buffers, copied
when its last completion is polled, equal the reference unpack; every
frame gets one ACK with its (msg_id, offset); the allocator drops
nothing; and the MPQ's eviction counter counts no more than the slot
hand-overs inside one step (a message ending in the step that the next
message in its slot begins: the batched scheduler counts them as
evictions although no message loses its state; a counter that does not
reads 0 and passes too).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from bench import harness as H
from bench.ref import ddt as rddt
from bench.ref import frames as rf


@dataclasses.dataclass
class Stream:
    """The staged frames and, for each message instance of the ring, where
    its frames fall."""
    data: object          # (ring_steps, batch, MTU) uint8 on the device
    length: object        # (ring_steps, batch) int32
    valid: object         # (ring_steps, batch) bool
    ids: np.ndarray       # (rounds, messages) msg ids
    base: int             # ids[0, 0]
    acks: np.ndarray      # (ring_steps, batch, 2) (msg_id, offset), sorted
    expect: np.ndarray    # (rounds, messages, mem_bytes) reference unpack
    msg_bytes: int
    mem_bytes: int
    frames_per_msg: int
    frame_bytes: int      # live frame bytes in a ring pass
    ring_steps: int


def stage(cfg: dict, traffic: dict, seed: int, device) -> Stream:
    import torch
    c = rddt.commit(rddt.fig9(cfg["datatype"]), cfg["count"])
    n_msg, rounds = traffic["messages"], traffic["rounds_staged"]
    batch = cfg["nic"]["batch"]
    rng = np.random.default_rng(seed)
    # ids of round r: base + r * messages + i, base a multiple of
    # 2 * messages, so round parity picks the set of receive buffers
    base = 2 * n_msg * int(rng.integers(1, 1 << 20))
    ids = base + np.arange(rounds * n_msg).reshape(rounds, n_msg)
    # the sender's buffers are contiguous (a matching type signature of
    # floats), so the bytes that overlapping blocks repeat differ and the
    # order of the unpack decides what lands
    msgs = rng.integers(0, 256, size=(rounds, n_msg, c.msg_bytes),
                        dtype=np.uint8)
    zero = np.zeros(c.mem_bytes, np.uint8)
    data, length, acks = [], [], []
    expect = np.empty((rounds, n_msg, c.mem_bytes), np.uint8)
    for r in range(rounds):
        segs = []
        for i in range(n_msg):
            msg = msgs[r, i]
            expect[r, i] = rddt.unpack(c, msg, zero)
            segs.append(rf.segment(msg, int(ids[r, i]), cfg["port"]))
        # one frame of each message in turn
        data.append(np.stack([s[0] for s in segs], 1).reshape(-1, rf.MTU))
        length.append(np.stack([s[1] for s in segs], 1).reshape(-1))
        acks.append(np.stack([np.stack(
            [np.full(len(s[2]), ids[r, i]), s[2]], 1)
            for i, s in enumerate(segs)], 1).reshape(-1, 2))
    data, length, acks = (np.concatenate(x) for x in (data, length, acks))
    if len(length) % batch or rounds % 2:
        raise ValueError(f"{rounds} staged rounds of {n_msg} messages do "
                         f"not fill whole steps of {batch} frames in an "
                         f"even number of rounds")
    steps = len(length) // batch
    acks = acks.reshape(steps, batch, 2)
    acks = np.take_along_axis(
        acks, np.lexsort((acks[..., 1], acks[..., 0]), axis=-1)[..., None],
        axis=1)
    return Stream(
        data=torch.as_tensor(data, device=device).reshape(steps, batch, -1),
        length=torch.as_tensor(length, device=device).reshape(steps, batch),
        valid=torch.ones((steps, batch), dtype=torch.bool, device=device),
        ids=ids, base=base, acks=acks, expect=expect, msg_bytes=c.msg_bytes,
        mem_bytes=c.mem_bytes, frames_per_msg=len(segs[0][1]),
        frame_bytes=int(length.sum()), ring_steps=steps)


class Schedule:
    """Where each message instance's first and last frames fall: instance
    ``(p, r, i)``, message i of staged round r on ring pass p, is the
    global message number ``(p * rounds + r) * messages + i``."""

    def __init__(self, s: Stream, batch: int):
        self.rounds, self.n_msg = s.ids.shape
        self.f, self.batch = s.frames_per_msg, batch
        self.round_frames = self.n_msg * self.f

    def first_step(self, m):
        m = np.asarray(m)
        return ((m // self.n_msg) * self.round_frames
                + m % self.n_msg) // self.batch

    def last_step(self, m):
        m = np.asarray(m)
        return ((m // self.n_msg) * self.round_frames
                + (self.f - 1) * self.n_msg + m % self.n_msg) // self.batch

    def started_by(self, step: int) -> int:
        """The number of messages whose first frame is in steps
        [0, step]."""
        frames = (step + 1) * self.batch
        full, rest = divmod(frames, self.round_frames)
        return full * self.n_msg + min(rest, self.n_msg)

    def handovers(self, last_step: int) -> int:
        """Messages that begin in the step in which the previous message
        of their MPQ slot (``messages`` earlier) ends, up to ``last_step``."""
        m = np.arange(self.n_msg, self.started_by(last_step))
        return int((self.first_step(m) == self.last_step(m - self.n_msg))
                   .sum())


def _plant(plant, spin_nic):
    """Faults and the control put under the timed path (tests and
    ``bench/control.py``).  Returns what undoes them."""
    saved = (spin_nic.scatter_set_, spin_nic.SpinNIC.step)

    def undo():
        spin_nic.scatter_set_, spin_nic.SpinNIC.step = saved
    if "first_write_wins" in plant:
        # the control: the host DMA scatter keeps the first write of a
        # repeated byte, not the last (overlapping blocks go wrong)
        from repro_torch.core import scatter as sc

        def first_wins(dst, idx, val):
            idx = idx.reshape(-1)
            return sc.scatter_set_(dst, idx.flip(0), val.reshape(-1).flip(0))
        spin_nic.scatter_set_ = first_wins
    step = spin_nic.SpinNIC.step
    if "state_unchanged" in plant:
        def unchanged(self, state, batch):
            keep = state.clone()
            _, eg, th = step(self, state, batch)
            return keep, eg, th
        spin_nic.SpinNIC.step = unchanged
    if "half_batch" in plant:
        def half(self, state, batch):
            valid = batch.valid.clone()
            valid[batch.n // 2:] = False
            return step(self, state, dataclasses.replace(batch, valid=valid))
        spin_nic.SpinNIC.step = half
    if "altered_answer" in plant:
        def altered(self, state, batch):
            st, eg, th = step(self, state, batch)
            st.host[7] += 1
            return st, eg, th
        spin_nic.SpinNIC.step = altered
    return undo


def run(cell: H.Cell) -> H.Outcome:
    from repro_torch.core import alloc, spin_nic
    geo = cell.config["nic"]
    if (alloc.L2_PKT_BYTES, alloc.N_SMALL, alloc.N_LARGE) != (
            geo["l2_bytes"], geo["small_slots"], geo["large_slots"]):
        raise ValueError("the program's L2 geometry differs from the "
                         "configuration's")
    marks = H.Stages(cell.t0)
    marks.mark("imports")
    undo = _plant(cell.plant, spin_nic)
    try:
        return _run(cell, marks, spin_nic)
    finally:
        undo()


def _run(cell: H.Cell, marks: H.Stages, spin_nic) -> H.Outcome:
    import torch
    from repro_torch.core import apps, ddt as pddt, her, slmp
    from repro_torch.core import packet as ppkt
    cfg, traffic, dev = cell.config, cell.workload["traffic"], cell.device
    geo = cfg["nic"]
    s = stage(cfg, traffic, cell.seed, dev)
    marks.mark("frames staged")
    sched = Schedule(s, geo["batch"])
    n_msg, buffers = traffic["messages"], 2 * traffic["messages"]
    # the program's own commit of the datatype, and its NIC
    committed = pddt.commit(getattr(pddt, f"{cfg['datatype']}_ddt")(),
                            count=cfg["count"])
    ctx = apps.make_ddt_context(committed, port=cfg["port"],
                                msgs_in_flight=buffers, device=dev)
    nic = spin_nic.SpinNIC([ctx], host_bytes=buffers * s.mem_bytes,
                           batch=geo["batch"],
                           mpq_entries=geo["mpq_entries"], device=dev)
    if nic.mpq_entries != her.MPQ_ENTRIES:
        raise ValueError("MPQ size differs from the program's")
    half = n_msg * s.mem_bytes
    rec = dict(issue=[], ret=[], poll=[], done=[], egress=[])
    archive = {}                  # global round -> its buffers, copied
    seen = {}                     # global round -> completions polled
    state = nic.init_state()

    def do_step(k: int, labelled: bool = False):
        nonlocal state
        b = k % s.ring_steps
        batch = ppkt.PacketBatch(s.data[b], s.length[b], s.valid[b])
        rec["issue"].append(time.perf_counter())
        with H.label("nic.step", labelled):
            state, eg, _ = nic.step(state, batch)
        rec["ret"].append(time.perf_counter())
        with H.label("nic.poll", labelled):
            done, state = nic.pop_counters(state, slmp.COMPLETION_QUEUE)
        rec["poll"].append(time.perf_counter())
        rec["egress"].append((eg.valid, eg.data[:, rf.SLMP_FLAGS:
                                                 rf.SLMP_PAYLOAD]))
        for mid in done.tolist():
            rec["done"].append((k, mid))
            r = (mid - s.base) // n_msg
            if not 0 <= r < sched.rounds:
                continue
            # the latest round of the stream that is staged round r
            q = (sched.started_by(k) - 1) // n_msg
            g = q - (q - r) % sched.rounds
            seen[g] = seen.get(g, 0) + 1
            if seen[g] == n_msg:
                lo = (g % 2) * half
                archive[g] = state.host[lo:lo + half].clone()

    marks.mark("NIC built")
    k = 0
    for _ in range(traffic["warmup_steps"]):
        do_step(k)
        k += 1
    H.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks.mark("warm-up steps")
    setup_s = time.perf_counter() - cell.t0
    w0 = time.perf_counter()
    first = k
    while True:
        do_step(k)
        k += 1
        if rec["poll"][-1] - w0 >= cell.seconds:
            break
    window_s = rec["poll"][-1] - w0
    last = k - 1                          # the window's last step
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if cell.trace:
        # a whole number of rounds' completions: from a ring boundary, the
        # steps up to and including the first round's last frame
        while k % s.ring_steps:
            do_step(k)
            k += 1
        n_prof = int(sched.last_step(n_msg - 1)) + 1
        start = k

        def traced():
            nonlocal k
            for _ in range(n_prof):
                do_step(k, labelled=True)
                k += 1
        trace = H.profile(traced, dev)
        trace_steps = (start, n_prof)
    # drain: until every message begun has completed
    begun = sched.started_by(k - 1)
    while k <= int(sched.last_step(begun - 1)):
        do_step(k)
        k += 1
    H.sync(dev)

    # ------------------------------------------------------------ checks
    steps = k
    n_ids = sched.rounds * n_msg
    due = np.arange(begun)
    due_step = sched.last_step(due)
    due_id = s.ids.reshape(-1)[due % n_ids]
    want = set(zip(due_step.tolist(), due_id.tolist()))
    got = set(rec["done"])
    repeats = len(rec["done"]) - len(got)
    missing_or_extra = len(want ^ got) + repeats
    wrong_msgs = {int(m) for m in due
                  if (int(due_step[m]), int(due_id[m])) not in got}
    # the buffers of every round that was due
    wrong_bytes = 0
    for g in range(begun // n_msg):
        ref = s.expect[g % sched.rounds].reshape(-1)
        if g not in archive:
            wrong_bytes += ref.size
            wrong_msgs.update(range(g * n_msg, (g + 1) * n_msg))
            continue
        bad = archive[g].cpu().numpy() != ref
        if bad.any():
            wrong_bytes += int(bad.sum())
            wrong_msgs.update(g * n_msg
                              + np.flatnonzero(bad.reshape(n_msg, -1).any(1)))
    # ACKs, step by step
    ack_wrong = 0
    for lo in range(0, steps, 1024):
        part = rec["egress"][lo:lo + 1024]
        valid = torch.stack([v for v, _ in part]).cpu().numpy()
        hdr = torch.stack([h for _, h in part]).cpu().numpy()
        flags = (hdr[..., 0].astype(np.int64) << 8) | hdr[..., 1]
        is_ack = valid & ((flags & rf.FLAG_ACK) != 0)
        rows = hdr.reshape(-1, hdr.shape[-1])
        mid = rf.read_field(rows, 2, 4).reshape(valid.shape)
        off = rf.read_field(rows, 6, 4).reshape(valid.shape)
        got_a = np.stack([np.where(is_ack, mid, -1),
                          np.where(is_ack, off, -1)], -1)
        got_a = np.take_along_axis(got_a, np.lexsort(
            (got_a[..., 1], got_a[..., 0]), axis=-1)[..., None], axis=1)
        want_a = s.acks[np.arange(lo, lo + len(part)) % s.ring_steps]
        ack_wrong += int((got_a != want_a).any(-1).sum())
    evictions = int(state.mpq.evictions)
    checks = [
        H.Check("completions_missing_or_extra", float(missing_or_extra),
                0.0),
        H.Check("buffer_bytes_wrong", float(wrong_bytes), 0.0),
        H.Check("acks_wrong", float(ack_wrong), 0.0),
        H.Check("frames_dropped", float(int(state.dropped)), 0.0),
        # the batched MPQ counts a slot handed over inside a step as an
        # eviction; no more than those may be counted
        H.Check("mpq_evictions_beyond_handovers",
                float(max(0, evictions - sched.handovers(steps - 1))), 0.0),
    ]

    # -------------------------------------------------------- readings
    # messages whose completion was polled in the window, by the host
    # clock from the issue of the step with their first frame
    in_window = [(st_, mid) for st_, mid in rec["done"]
                 if first <= st_ <= last]
    first_steps = sched.first_step(due)
    lat = [(rec["poll"][due_step[m]] - rec["issue"][first_steps[m]]) * 1e3
           for m in np.flatnonzero((due_step >= first) & (due_step <= last))
           if (int(due_step[m]), int(due_id[m])) in got]
    n_win = last - first + 1
    readings = {
        "setup_s": setup_s, "window_s": window_s, "steps": n_win,
        "messages_done": len(in_window), "msg_bytes": s.msg_bytes,
        "latency_ms": lat,
        "host_step_ms": [(rec["ret"][i] - rec["issue"][i]) * 1e3
                         for i in range(first, last + 1)],
        # live frame bytes in plus message bytes written to host memory,
        # a step on average over the ring
        "necessary_bytes_per_step": (s.frame_bytes + sched.rounds * n_msg
                                     * s.msg_bytes) / s.ring_steps,
        "evictions": evictions,
    }
    if trace is not None:
        readings["trace"] = trace
        readings["trace_steps"] = trace_steps[1]
    return H.Outcome(readings=readings, checks=checks, attempted=begun,
                     failed=len(wrong_msgs),
                     memory_peak_bytes=int(peak), trace=trace)
