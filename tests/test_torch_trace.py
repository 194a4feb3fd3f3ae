"""The port's tracing (``repro_torch.trace``): the recorder itself, and the
spans and ``host_syncs`` counts that ``SpinNIC.step``, ``pop_counters``,
``SpinIngest``, ``overlapped_loop``, the Trainer's step and
``ServeEngine`` record, on the CPU.  Tracing never changes a result."""
import dataclasses
import threading
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import mamba2_780m  # noqa: E402
from repro_torch.core import apps, ddt, overlap, slmp, spin_nic  # noqa: E402
from repro_torch.core import packet as pkt  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

CPU = "cpu"
B = 8                                    # frames a NIC step
NIC_STAGES = ["spin_nic.step", "spin_nic.match", "spin_nic.alloc",
              "spin_nic.l2_dma", "spin_nic.her", "spin_nic.handlers",
              "spin_nic.handlers.header", "spin_nic.handlers.packet",
              "spin_nic.handlers.tail", "spin_nic.host_dma",
              "spin_nic.egress", "spin_nic.counters", "spin_nic.free"]


@pytest.fixture
def tracing():
    """Tracing on for the test, with nothing left over before or after."""
    trace.collect()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.collect()


def _names(spans):
    return [s.name for s in spans]


def _inside(spans, child, parent):
    c, p = spans[child], spans[parent]
    return p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns


# ----------------------------------------------------------- the recorder
def test_off_span_is_one_shared_null_context_and_records_nothing():
    trace.collect()
    a, b = trace.span("x"), trace.span("y", request=3)
    assert a is b
    with a:
        trace.count("host_syncs")
    assert trace.collect() == ([], {})


def test_off_span_reads_no_clock_and_allocates_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read")
    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)

    def loop():
        for _ in range(20000):
            with trace.span("spin_nic.step", request=7):
                trace.count("host_syncs")
    loop()                                     # warm
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        loop()
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before


def test_nesting_gives_parent_and_request_is_inherited(tracing):
    with trace.span("a", request="r1"):
        with trace.span("b"):
            with trace.span("c", request="r2"):
                with trace.span("d"):
                    pass
        with trace.span("e"):
            pass
    with trace.span("f"):
        pass
    spans, _ = trace.collect()
    assert _names(spans) == list("abcdef")
    assert [s.parent for s in spans] == [None, 0, 1, 2, 0, None]
    assert [s.request for s in spans] == ["r1", "r1", "r2", "r2", "r1",
                                          None]
    for i, s in enumerate(spans):
        assert 0 < s.start_ns <= s.end_ns
        if s.parent is not None:
            assert _inside(spans, i, s.parent)


def test_threads_keep_separate_stacks(tracing):
    opened, go = threading.Event(), threading.Event()

    def other():
        with trace.span("t.outer"):
            opened.set()
            go.wait(10)
            with trace.span("t.inner"):
                pass

    with trace.span("main.outer", request=1):
        th = threading.Thread(target=other)
        th.start()
        assert opened.wait(10)
        with trace.span("main.inner"):
            go.set()
            th.join(10)
    assert not th.is_alive()
    spans, _ = trace.collect()
    by = {s.name: (i, s) for i, s in enumerate(spans)}
    assert by["main.inner"][1].parent == by["main.outer"][0]
    assert by["t.inner"][1].parent == by["t.outer"][0]
    assert by["t.outer"][1].parent is None
    assert by["t.outer"][1].request is None
    assert by["t.outer"][1].thread != by["main.outer"][1].thread
    assert by["t.inner"][1].thread == by["t.outer"][1].thread


def test_count_adds_and_collect_clears(tracing):
    trace.count("host_syncs")
    trace.count("host_syncs", 4)
    trace.count("other")
    assert trace.collect() == ([], {"host_syncs": 5, "other": 1})
    assert trace.collect() == ([], {})


def test_a_profiler_turns_tracing_on_and_sees_each_span():
    """A profiler turns recording on but sees no span; after
    ``enable(annotate=True)`` it sees each one as a region."""
    from torch.profiler import ProfilerActivity, profile

    def spans_under_profiler():
        x = torch.ones(64)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("outer", request=5):
                with trace.span("inner"):
                    x = x * 2
            trace.count("host_syncs")
        return [e.name for e in prof.events()
                if e.name in ("outer", "inner")]

    trace.collect()
    assert spans_under_profiler() == []
    with trace.span("after"):                  # off again
        pass
    spans, counters = trace.collect()
    assert _names(spans) == ["outer", "inner"]
    assert counters == {"host_syncs": 1}
    trace.enable(annotate=True)
    try:
        assert spans_under_profiler() == ["outer", "inner"]
    finally:
        trace.disable()
    assert _names(trace.collect()[0]) == ["outer", "inner"]
    trace.enable()                             # annotate is off again
    try:
        assert spans_under_profiler() == []
    finally:
        trace.disable()
        trace.collect()


# ------------------------------------------------------------- the NIC
def _nic_and_frames():
    c = ddt.commit(ddt.complex_ddt(), count=8)
    nic = spin_nic.SpinNIC(
        [apps.make_ddt_context(c, port=9332, msgs_in_flight=4, device=CPU)],
        host_bytes=4 * c.mem_bytes, batch=B, device=CPU)
    rng = np.random.default_rng(11)
    lists = [slmp.segment_message(
        rng.integers(0, 256, c.msg_bytes).astype(np.uint8), mid,
        slmp.SlmpSenderConfig(window=1, port=9332, mtu_payload=96))
        for mid in (1, 2)]
    frames = [f for pair in zip(*lists) for f in pair]
    batches = [pkt.stack_frames(frames[i:i + B], n=B, device=CPU)
               for i in range(0, len(frames), B)]
    return nic, batches


def _run_nic(nic, batches):
    state, out = nic.init_state(), []
    for b in batches:
        state, eg, th = nic.step(state, b)
        done, state = nic.pop_counters(state, slmp.COMPLETION_QUEUE)
        out.append((state.to_numpy(), eg.numpy(), th.numpy(), done))
    return out


def test_nic_step_is_bit_identical_with_tracing_on():
    nic, batches = _nic_and_frames()
    assert len(batches) >= 3
    trace.collect()
    off = _run_nic(nic, batches)
    trace.enable()
    try:
        on = _run_nic(nic, batches)
    finally:
        trace.disable()
        spans, counters = trace.collect()
    assert spans and counters["host_syncs"] > 0
    for (s0, e0, t0, d0), (s1, e1, t1, d1) in zip(off, on):
        assert sorted(s0) == sorted(s1)
        for k in s0:
            np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
        for a, b in zip(e0 + t0, e1 + t1):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(d0, d1)
    assert sum(len(d) for *_, d in on) == 2        # both messages complete


def test_nic_step_records_its_13_spans_in_stage_order(tracing):
    nic, batches = _nic_and_frames()
    state = nic.init_state()
    trace.collect()                   # the frames' copies in, made above
    for k, b in enumerate(batches):
        state, _, _ = nic.step(state, b)
        spans, counters = trace.collect()
        assert _names(spans) == NIC_STAGES
        # each scatter_set_ reads its winner of index 0 on the host: the
        # L2 copy, three in HER/MPQ, the host DMA, 4 queues x 3 phases of
        # counter FIFOs, two in the slot free
        assert counters == {"host_syncs": 1 + 3 + 1 + 12 + 2}
        assert all(s.request == k + 1 for s in spans)   # the step count
        assert spans[0].parent is None
        for i, s in enumerate(spans[1:], 1):
            parent = 5 if s.name.startswith("spin_nic.handlers.") else 0
            assert s.parent == parent and _inside(spans, i, parent)
        for a, b2 in zip(spans[1:], spans[2:]):          # in stage order
            assert a.start_ns <= b2.start_ns
    assert nic.steps_run == len(batches)


def test_pop_counters_counts_one_sync_when_empty_and_three_with_entries(
        tracing):
    nic, batches = _nic_and_frames()
    state = nic.init_state()
    trace.collect()                   # the frames' copies in, made above
    done, state = nic.pop_counters(state, slmp.COMPLETION_QUEUE)
    spans, counters = trace.collect()
    assert len(done) == 0 and counters == {"host_syncs": 1}
    assert _names(spans) == ["spin_nic.pop_counters"]
    for b in batches:
        state, _, _ = nic.step(state, b)
    trace.collect()
    done, state = nic.pop_counters(state, slmp.COMPLETION_QUEUE)
    _, counters = trace.collect()
    # the count, the values, and the count cleared with a host value
    assert sorted(done.tolist()) == [1, 2] and counters == {"host_syncs": 3}
    nic.read_host(state, 0, 16)
    assert trace.collect()[1] == {"host_syncs": 1}


# ------------------------------------------------- ingest and the overlap
def test_ingest_and_overlapped_loop_spans_and_syncs(tracing):
    pl = tdata.PacketizedPipeline(256, 2, 16, port=9330)
    spin = tdata.SpinIngest(pl, device=CPU)
    feeds = [pl.packets_for_step(j) for j in range(3)]
    seen = []

    def compute(state, batch):
        seen.append(batch["tokens"])
        return state + 1
    state, rep = overlap.overlapped_loop(spin, compute, feeds, 0,
                                         device=CPU)
    assert state == 3 and rep.steps == 3
    spans, counters = trace.collect()
    calls = [i for i, s in enumerate(spans) if s.name == "ingest.call"]
    assert len(calls) == 3
    for i in calls:
        kids = [s.name for s in spans if s.parent == i]
        assert kids == ["ingest.match", "ingest.reassemble", "ingest.gather"]
    waits = [(s.name, s.request) for s in spans
             if s.name.startswith("overlap.")]
    assert waits == [("overlap.wait_compute", 0), ("overlap.wait_ingest", 0),
                     ("overlap.wait_compute", 1), ("overlap.wait_ingest", 1),
                     ("overlap.wait_compute", 2)]
    # the prologue's wait, then two a step but the last's one; each ingest
    # call copies three arrays in and reassembles with one scatter_set_
    assert counters == {"host_syncs": (1 + 2 * 3 - 1) + 3 * (3 + 1)}
    for j, toks in enumerate(seen):
        want = pl.corpus.batch(j, 2, 16)[:, :-1]
        np.testing.assert_array_equal(toks.numpy(), want)


# ------------------------------------------------- the Trainer and serving
def _mamba(remat="none"):
    cfg = dataclasses.replace(mamba2_780m.smoke(), dtype="float32",
                              remat=remat)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def test_trainer_step_spans_remat_recompute_and_same_gradients():
    cfg, model, params = _mamba(remat="dots")
    step = Trainer(model, popt.OptConfig(lr=1e-2, warmup_steps=0),
                   TrainerConfig()).build_step()
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 20)))
             for k in ("tokens", "targets")}
    start = [p.detach().clone() for p in T.leaves(params.tree())]
    results = []
    for on in (False, True):
        with torch.no_grad():
            for p, s in zip(T.leaves(params.tree()), start):
                p.copy_(s)
        trace.collect()
        if on:
            trace.enable()
        try:
            _, ost, met = step(params, popt.init(params.tree()), batch)
        finally:
            trace.disable()
        results.append(([p.detach().clone() for p in
                         T.leaves(params.tree())],
                        [m.clone() for m in T.leaves(ost.mu)],
                        float(met["grad_norm"]), trace.collect()))
    (p0, m0, g0, (none, _)), (p1, m1, g1, (spans, _)) = results
    assert none == [] and g0 == g1
    for a, b in zip(p0 + m0, p1 + m1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    names = _names(spans)
    assert names[0] == "trainer.step" and spans[0].parent is None
    for name in ("trainer.forward", "trainer.backward",
                 "trainer.optimizer"):
        (i,) = [j for j, n in enumerate(names) if n == name]
        assert spans[i].parent == 0 and _inside(spans, i, 0)
    # under remat each layer's chunked scan runs in the forward and again
    # in the backward's recompute
    chunked = [s for s in spans if s.name == "ssm.chunked"]
    assert len(chunked) == 2 * cfg.n_layers
    main = spans[0].thread
    parents = [names[s.parent] for s in chunked if s.thread == main]
    assert parents.count("trainer.forward") == cfg.n_layers
    assert set(parents) <= {"trainer.forward", "trainer.backward"}


def test_serve_step_records_one_step_and_one_decode_per_layer(tracing):
    cfg, model, params = _mamba()
    engine = ServeEngine(model, params, max_len=16)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 8)))
    st = engine.prefill({"tokens": toks})
    spans, _ = trace.collect()
    assert _names(spans) == ["serve.prefill"] + ["ssm.chunked"] * cfg.n_layers
    assert st.request == engine.prefills == 1
    for k in range(3):
        _, st = engine.step(st)
        spans, counters = trace.collect()
        assert _names(spans) == ["serve.step"] + ["ssm.decode"] * cfg.n_layers
        assert all(s.request == 1 for s in spans)
        assert all(s.parent == 0 for s in spans[1:])
        assert counters == {"host_syncs": 1}   # the position copied in
    assert engine.prefill({"tokens": toks}).request == 2


def test_profiled_nic_serve_and_train_steps_hold_no_span_event():
    """Unless annotated, the program's spans add no event to a profile of
    its paths, so a profile's operations and busy time count what they
    did before the spans (``chip_smoke.profile_step`` keeps every device
    event)."""
    from torch.profiler import ProfilerActivity, profile
    nic, batches = _nic_and_frames()
    state = nic.init_state()
    cfg, model, params = _mamba()
    engine = ServeEngine(model, params, max_len=12)
    served = engine.prefill({"tokens": torch.zeros(2, 4, dtype=torch.long)})
    step = Trainer(model, popt.OptConfig(lr=1e-2, warmup_steps=0),
                   TrainerConfig()).build_step()
    batch = {k: torch.zeros(2, 8, dtype=torch.long)
             for k in ("tokens", "targets")}
    ost = popt.init(params.tree())
    trace.collect()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _, _ = nic.step(state, batches[0])
        nic.pop_counters(state, slmp.COMPLETION_QUEUE)
        engine.step(served)
        step(params, ost, batch)
    names = set(_names(trace.collect()[0]))
    assert {"spin_nic.step", "spin_nic.pop_counters", "serve.step",
            "ssm.decode", "trainer.step", "ssm.chunked"} <= names
    assert not any(e.name in names or getattr(e, "is_user_annotation",
                                              False)
                   for e in prof.events())
