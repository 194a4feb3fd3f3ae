"""The PyTorch port on an NVIDIA GPU: the CUDA kernels K1 (matcher, both
forms), K2 (DDT gather, both bodies), K3 (checksum), K4 (flash
attention, with the lse it writes for K4b; tolerance at ``LSE_ATOL``),
K4b (its backward; tolerances at ``K4B_REL``) and K5 (mamba2's SSD
decode mixer, with its planted faults; tolerances at ``K5_ROW_TOL``)
against their plain versions, a small train step on the card against the CPU,
``SpinNIC.step`` / ``SpinIngest`` on CUDA against the same calls on the
CPU, the serving path's kernel launches, the moe, ssm and hybrid
layers (``moe_apply`` routing, drops and outputs, a bfloat16
``moe_apply`` twice bit for bit, ``ssd_chunked``, the rglru scan) on
the card against the CPU, and the fabric and MPI layer (threefry
draws, a lossy SLMP fabric tick for tick, a rendezvous with NIC unpack)
on the card against the CPU.  Tolerance: exact (0)
for K1-K3; K2 compares bit patterns.  K4 holds two limits at once: the
max abs error (bfloat16 0.06, the tolerance the JAX package holds its own
kernel to; float32 1e-4) and the row error, each row's largest error over
that row's RMS (bfloat16 0.1, float32 1e-4), which sees a fault in the
rows whose outputs are small.  bfloat16: the kernel rounds P to bfloat16
before P.V, as the TPU kernel does, and the output is rounded to
bfloat16; float32: exp and the sums over up to 1,000 keys run in another
order.

Every test here is marked ``cuda`` and skips where torch.cuda is not
available.  This file imports nothing of JAX, so it also runs on a machine
with only PyTorch:  PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import apps, ddt, packet as pkt, slmp  # noqa: E402
from repro_torch.core import checksum, matching, overlap, spin_nic  # noqa: E402
from repro_torch.kernels.checksum import ops as ck_ops  # noqa: E402
from repro_torch.kernels.checksum.ref import checksum_ref  # noqa: E402
from repro_torch.kernels.ddt import ops as ddt_ops  # noqa: E402
from repro_torch.kernels.ddt.ref import ddt_gather_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, row_error)
from repro_torch.kernels.matcher import ops as match_ops  # noqa: E402
from repro_torch.kernels.matcher.ref import (  # noqa: E402
    match_first_ref, match_ref)
from repro_torch.kernels.ssm_decode import ops as k5_ops  # noqa: E402
from repro_torch.kernels.ssm_decode.ref import (  # noqa: E402
    ssm_decode_mixer_ref)
from repro_torch.train import data as tdata  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda")


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(min(n, 97)):
        pay = rng.integers(0, 256, int(rng.integers(0, 80))).astype(np.uint8)
        out.append([pkt.make_icmp_echo(pay),
                    pkt.make_udp(pay, dport=9999),
                    pkt.make_slmp(i, 0, pkt.SLMP_FLAG_EOM, pay),
                    pkt.make_udp(pay, dport=7)][i % 4])
    data = pkt.stack_frames_np(out)[0]
    return np.resize(data, (n, pkt.MTU))


def _tables(seed):
    rs = [matching.ruleset_icmp_echo(), matching.ruleset_udp_pingpong(9999),
          matching.ruleset_slmp(9330), matching.ruleset_none()]
    yield np.stack([r.as_array() for r in rs]), \
        np.array([r.mode for r in rs], np.int32)
    rng = np.random.default_rng(seed)
    rules = np.zeros((6, 4, 4), np.uint32)
    rules[..., 0] = rng.integers(0, pkt.WORDS + 8, (6, 4))  # some idx >= W
    rules[..., 1] = rng.choice(np.array([0xFF, 0xFFFF0000, 0xFFFFFFFF, 0],
                                        np.uint32), (6, 4))
    rules[..., 2] = rng.integers(0, 2**31, (6, 4))
    rules[..., 3] = rules[..., 2] + rng.integers(0, 2**31, (6, 4))
    yield rules, rng.integers(0, 2, 6).astype(np.int32)


@pytest.mark.parametrize("n", [1, 64, 4097])
def test_match_kernel_equals_plain(cuda, n):
    for kind in ("wire", "random"):
        data = _frames(n, n) if kind == "wire" else np.random.default_rng(
            n).integers(0, 256, (n, pkt.MTU)).astype(np.uint8)
        d = torch.as_tensor(data, device=cuda)
        for rules, modes in _tables(n):
            r = torch.as_tensor(rules.astype(np.int64), device=cuda)
            m = torch.as_tensor(modes, device=cuda)
            before = match_ops.launches
            got = match_ops.match(d, r, m)
            torch.cuda.synchronize()
            assert match_ops.launches == before + 1
            want = match_ref(d, r, m)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


def _random_table(c, seed):
    """C contexts of random rules (idx up to W + 7, both modes), with the
    built-in ICMP and SLMP contexts at 1 and 2 where C > 2."""
    rng = np.random.default_rng(seed)
    rules = np.zeros((c, 4, 4), np.uint32)
    rules[..., 0] = rng.integers(0, pkt.WORDS + 8, (c, 4))
    rules[..., 1] = rng.choice(np.array([0xFF, 0xFF00, 0xFFFF0000,
                                         0xFFFFFFFF, 0], np.uint32), (c, 4))
    rules[..., 2] = rng.integers(0, 2**31, (c, 4))
    rules[..., 3] = rules[..., 2] + rng.integers(0, 2**31, (c, 4))
    modes = rng.integers(0, 2, c).astype(np.int32)
    if c > 2:
        for k, rs in ((1, matching.ruleset_icmp_echo()),
                      (2, matching.ruleset_slmp(9330))):
            rules[k], modes[k] = rs.as_array(), rs.mode
    return rules, modes


@pytest.mark.parametrize("n", [64, 65536])
def test_match_first_kernel_equals_plain(cuda, n):
    """The fused K1 against match_ref and the first-match epilogue, bit for
    bit: wire and random frames, the built-in tables and random ones of 1,
    3 and 8 contexts, a fifth of the lanes not valid."""
    rng = np.random.default_rng(n)
    valid = torch.as_tensor(rng.random(n) < 0.8, device=cuda)
    for kind in ("wire", "random"):
        data = _frames(n, n) if kind == "wire" else rng.integers(
            0, 256, (n, pkt.MTU)).astype(np.uint8)
        d = torch.as_tensor(data, device=cuda)
        tables = list(_tables(n)) + [_random_table(c, n + c)
                                     for c in (1, 3, 8)]
        for rules, modes in tables:
            r = torch.as_tensor(rules.astype(np.int64), device=cuda)
            m = torch.as_tensor(modes, device=cuda)
            before = match_ops.launches
            ctx, eom = match_ops.match_first(d, r, m, valid)
            torch.cuda.synchronize()
            assert match_ops.launches == before + 1
            want_ctx, want_eom = match_first_ref(d, r, m, valid)
            assert torch.equal(ctx, want_ctx) and torch.equal(eom, want_eom)
            assert ctx.dtype == torch.int32 and eom.dtype == torch.bool


@pytest.mark.parametrize("layout", ["rows_of_1540", "offset_4", "rows_of_36"])
def test_match_first_kernel_without_staged_heads(cuda, layout):
    """Frames the kernel cannot stage 16 bytes at a time (a row size not a
    multiple of 16 or under 64 bytes, or a base 4 bytes off alignment)
    read every word from memory; same answers as the plain version."""
    rng = np.random.default_rng(len(layout))
    n = 1000
    row = {"rows_of_1540": 1540, "offset_4": pkt.MTU, "rows_of_36": 36}[
        layout]
    buf = torch.as_tensor(rng.integers(0, 256, n * row + 4).astype(np.uint8),
                          device=cuda)
    off = 4 if layout == "offset_4" else 0
    d = buf[off:off + n * row].view(n, row)
    assert d.is_contiguous() and (d.data_ptr() % 16 == 0) == (off == 0)
    valid = torch.as_tensor(rng.random(n) < 0.8, device=cuda)
    for c in (1, 3, 8):
        rules, modes = _random_table(c, c)
        rules[..., 1] = np.where(rules[..., 1] == 0xFFFFFFFF, 0xFF,
                                 rules[..., 1])     # let some rules pass
        r = torch.as_tensor(rules.astype(np.int64), device=cuda)
        m = torch.as_tensor(modes, device=cuda)
        ctx, eom = match_ops.match_first(d, r, m, valid)
        want_ctx, want_eom = match_first_ref(d, r, m, valid)
        assert torch.equal(ctx, want_ctx) and torch.equal(eom, want_eom)


def test_match_batch_is_one_launch(cuda):
    data, length, valid = pkt.stack_frames_np(
        [pkt.make_slmp(i, 0, pkt.SLMP_FLAG_EOM, np.arange(9, dtype=np.uint8),
                       dport=9331) for i in range(64)])
    batch = pkt.PacketBatch.from_numpy(data, length, valid, cuda)
    tables = matching.MatchTables.build([matching.ruleset_slmp(9331)],
                                        device=cuda)
    before = match_ops.launches
    ctx, eom = matching.match_batch(batch, tables)
    assert match_ops.launches == before + 1
    assert bool((ctx == 0).all()) and bool(eom.all())


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8,
                                   torch.bfloat16, torch.float64])
def test_gather_kernel_bit_exact(cuda, dtype):
    rng = np.random.default_rng(1)
    s, i = 4099, 70001
    raw = rng.integers(0, 2**63, s, dtype=np.int64)
    src = torch.as_tensor(raw).view(torch.uint8)[: s * torch.empty(
        (), dtype=dtype).element_size()].view(dtype).contiguous()
    if dtype.is_floating_point:
        src[::5] = -0.0
        src[1::7] = float("nan")
    idx = torch.as_tensor(rng.integers(-1, s + 50, i).astype(np.int32))
    fill = -0.0 if dtype.is_floating_point else 3
    before = ddt_ops.launches
    got = ddt_ops.gather(src.to(cuda), idx.to(cuda), fill=fill)
    torch.cuda.synchronize()
    assert ddt_ops.launches == before + 1
    want = ddt_gather_ref(src, idx, fill)
    assert torch.equal(_bits(got.cpu()), _bits(want))


def _contiguous_map(s, i, rng):
    """A piecewise-contiguous map, as a committed datatype gives: runs of
    random length and start (aligned or not), holes and indices >= S."""
    out, k = [], 0
    while k < i:
        ln = int(rng.integers(1, 40))
        kind = rng.random()
        if kind < 0.1:
            out.append(np.full(ln, -1))
        elif kind < 0.15:
            out.append(np.full(ln, s + 5))
        else:
            start = int(rng.integers(0, s))
            out.append(np.arange(start, start + ln))      # may pass S
        k += ln
    return np.concatenate(out)[:i].astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("offset", ["none", "src", "idx"])
def test_gather_vector_body_bit_exact(cuda, dtype, offset):
    """The vector body (16-byte groups) and the scalar path against the
    plain version, bit for bit: element sizes 1, 2, 4 and 8; src or idx a
    view one element in, which breaks 16-byte alignment (a misaligned src
    keeps the vector body but no run is aligned; a misaligned idx takes
    the scalar path); odd I; contiguous and random maps; -0.0 and NaN
    payloads kept."""
    rng = np.random.default_rng(len(offset))
    esize = torch.empty((), dtype=dtype).element_size()
    s = 5003
    raw = torch.as_tensor(rng.integers(0, 2**63, s + 1, dtype=np.int64))
    src = raw.view(torch.uint8)[: (s + 1) * esize].view(dtype)
    if dtype.is_floating_point:
        src[::5] = -0.0
        src[1::7] = float("nan")
    so, io = int(offset == "src"), int(offset == "idx")
    src = src.to(cuda)[so:so + s]
    fill = -0.0 if dtype.is_floating_point else 3
    for i in (1, 15, 4099, 70001):
        for name in ("contiguous", "random"):
            idx = _contiguous_map(s, i + 1, rng) if name == "contiguous" \
                else rng.integers(-1, s + 50, i + 1).astype(np.int32)
            ti = torch.as_tensor(idx, device=cuda)[io:io + i]
            assert (ti.data_ptr() % 16 == 0) == (io == 0)
            before = ddt_ops.launches
            got = ddt_ops.gather(src, ti, fill=fill)
            torch.cuda.synchronize()
            assert ddt_ops.launches == before + 1
            want = ddt_gather_ref(src.cpu(), ti.cpu(), fill)
            assert torch.equal(_bits(got.cpu()), _bits(want)), (i, name)


def test_wrappers_raise_on_bad_cuda_inputs(cuda):
    d = torch.zeros((4, 2 * pkt.MTU), dtype=torch.uint8, device=cuda)
    r = torch.zeros((1, 4, 4), dtype=torch.int64, device=cuda)
    m = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        match_ops.match(d[:, ::2], r, m)
    with pytest.raises(ValueError):
        ddt_ops.gather(torch.zeros(8, device=cuda)[::2],
                       torch.zeros(3, dtype=torch.int32, device=cuda))


def _ddt_nic(device, c):
    ctx = apps.make_ddt_context(c, msgs_in_flight=4, device=device)
    return spin_nic.SpinNIC([ctx, apps.make_icmp_context()],
                            host_bytes=4 * c.mem_bytes, batch=16,
                            device=device)


def test_spin_nic_step_cuda_equals_cpu(cuda):
    c = ddt.commit(ddt.complex_ddt(), count=64)
    rng = np.random.default_rng(2)
    msgs = [rng.integers(0, 256, c.msg_bytes).astype(np.uint8)
            for _ in range(4)]
    lists = [slmp.segment_message(m, i, slmp.SlmpSenderConfig(
        window=1, port=9331, mtu_payload=700)) for i, m in enumerate(msgs)]
    frames = [f for grp in zip(*lists) for f in grp]
    frames.insert(3, pkt.make_icmp_echo(np.arange(33, dtype=np.uint8)))
    gnic, cnic = _ddt_nic(cuda, c), _ddt_nic("cpu", c)
    gs, cs = gnic.init_state(), cnic.init_state()
    before = match_ops.launches
    steps = 0
    for k in range(0, len(frames), 16):
        batch = pkt.stack_frames_np(frames[k:k + 16], n=16)
        gs, geg, gth = gnic.step(gs, pkt.PacketBatch.from_numpy(*batch,
                                                                cuda))
        cs, ceg, cth = cnic.step(cs, pkt.PacketBatch.from_numpy(*batch,
                                                                "cpu"))
        steps += 1
        for a, b in zip(geg.numpy() + gth.numpy(), ceg.numpy() + cth.numpy()):
            np.testing.assert_array_equal(a, b)
        gd, cd = gs.to_numpy(), cs.to_numpy()
        for key in cd:
            np.testing.assert_array_equal(gd[key], cd[key], err_msg=key)
    assert match_ops.launches - before == steps
    for i, m in enumerate(msgs):
        want = ddt.unpack_np(c, m, np.zeros(c.mem_bytes, np.uint8))
        np.testing.assert_array_equal(
            gnic.read_host(gs, i * c.mem_bytes, c.mem_bytes), want)


def test_spin_ingest_and_overlap_on_cuda(cuda):
    pipe = tdata.PacketizedPipeline(vocab=1000, batch=4, seq=300)
    gi, ci = tdata.SpinIngest(pipe, device=cuda), tdata.SpinIngest(
        pipe, device="cpu")
    for step in range(3):
        raw = pipe.packets_for_step(step)
        m, g = match_ops.launches, ddt_ops.launches
        got = gi(raw)
        assert (match_ops.launches - m, ddt_ops.launches - g) == (1, 1)
        want = ci(raw)
        for k in ("tokens", "targets"):
            assert torch.equal(got[k].cpu(), want[k])
    w = torch.eye(256, device=cuda)
    feeds = [pipe.packets_for_step(i) for i in range(4)]

    def compute(state, batch):
        return state @ w + batch["tokens"][0, 0].to(torch.float32)

    s0 = torch.zeros((256, 256), device=cuda)
    a, ra = overlap.sequential_loop(gi, compute, feeds, s0, device=cuda)
    b, rb = overlap.overlapped_loop(gi, compute, feeds, s0, device=cuda)
    assert torch.equal(a, b)
    assert 0.0 <= ra.overlap_ratio <= 1.0 and 0.0 <= rb.overlap_ratio <= 1.0


@pytest.mark.parametrize("start", [0, 34, 35])
def test_checksum_kernel_bit_exact(cuda, start):
    rng = np.random.default_rng(start)
    n = 4099
    data = rng.integers(1, 256, (n, pkt.MTU)).astype(np.uint8)
    lengths = rng.integers(0, pkt.MTU + 1, n).astype(np.int32)
    lengths[:5] = [0, 1, start + 1, pkt.MTU - 1, pkt.MTU]
    d, ln = torch.as_tensor(data), torch.as_tensor(lengths)
    before = ck_ops.launches
    got = checksum.internet_checksum_batch(d.to(cuda), ln.to(cuda), start)
    torch.cuda.synchronize()
    assert ck_ops.launches == before + 1
    assert torch.equal(got.cpu(), checksum_ref(d, ln, start))
    icmp = [pkt.make_icmp_echo(rng.integers(0, 256, k).astype(np.uint8))
            for k in range(0, 130, 3)]
    data, lengths, _ = pkt.stack_frames_np(icmp)
    got = checksum.internet_checksum_batch(
        torch.as_tensor(data, device=cuda),
        torch.as_tensor(lengths, device=cuda), pkt.L4_BASE)
    assert not got.any()


def _checksum_inputs(n, start, seed):
    """N random frames over non-zero bytes (the byte after an odd length
    counts), with the edge lengths first: negative, 0, around ``start``,
    around the MTU and past it."""
    rng = np.random.default_rng(seed)
    data = rng.integers(1, 256, (n, pkt.MTU)).astype(np.uint8)
    lengths = rng.integers(0, pkt.MTU + 1, n).astype(np.int32)
    edges = [-7, -1, 0, start - 1, start, start + 1, pkt.MTU - 1, pkt.MTU,
             pkt.MTU + 7, 2**31 - 1]
    lengths[:len(edges)] = edges[:n]
    return torch.as_tensor(data), torch.as_tensor(lengths)


@pytest.mark.parametrize("start", [0, 34, 35])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 64, 4099, 65543])
def test_checksum_edge_cases_bit_exact(cuda, n, start):
    """K3 equals the plain version bit for bit at N around its 8-packet
    block and beyond, edge lengths included (2**31 - 1 has no live word,
    as in the reference); each call is one launch."""
    d, ln = _checksum_inputs(n, start, seed=n + start)
    want = checksum_ref(d, ln, start)
    before = ck_ops.launches
    got = ck_ops.internet_checksum(d.to(cuda), ln.to(cuda), start=start)
    torch.cuda.synchronize()
    assert ck_ops.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_checksum_row_slice_and_icmp(cuda):
    """A batch that is a row slice of a larger buffer (its data pointer
    offset by whole 1,536-byte rows, still 16-byte aligned), and ICMP echo
    requests, which verify to 0."""
    d, ln = _checksum_inputs(3000, 34, seed=7)
    gd, gl = d.to(cuda), ln.to(cuda)
    got = ck_ops.internet_checksum(gd[5:2905], gl[5:2905], start=34)
    assert torch.equal(got.cpu(), checksum_ref(d[5:2905], ln[5:2905], 34))
    rng = np.random.default_rng(8)
    icmp = [pkt.make_icmp_echo(rng.integers(0, 256, k).astype(np.uint8))
            for k in range(0, 1400, 7)]
    data, lengths, _ = pkt.stack_frames_np(icmp)
    got = ck_ops.internet_checksum(torch.as_tensor(data, device=cuda),
                                   torch.as_tensor(lengths, device=cuda),
                                   start=pkt.L4_BASE)
    assert got.numel() == len(icmp) and not got.any()


def test_checksum_raises_on_unaligned_rows(cuda):
    buf = torch.zeros(4 * pkt.MTU + 16, dtype=torch.uint8, device=cuda)
    ln = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ck_ops.internet_checksum(buf[8:8 + 4 * pkt.MTU].view(4, pkt.MTU), ln,
                                 start=34)
    with pytest.raises(ValueError):
        ck_ops.internet_checksum(buf[:4 * 40].view(4, 40), ln, start=34)


FA_CASES = [  # B, Sq, Sk, H, KV, D, causal, window, dtype
    (1, 300, 300, 4, 1, 256, True, 0, torch.bfloat16),
    (2, 300, 300, 4, 1, 256, True, 64, torch.bfloat16),
    (2, 200, 200, 16, 8, 128, True, 0, torch.bfloat16),
    (1, 1000, 1000, 2, 1, 128, True, 0, torch.bfloat16),
    (2, 70, 100, 2, 2, 64, False, 0, torch.bfloat16),
    (1, 130, 77, 4, 2, 128, False, 40, torch.bfloat16),
    (1, 65, 65, 2, 1, 64, True, 16, torch.float32),
    (2, 40, 90, 4, 4, 256, False, 0, torch.float32),
    # the Hopper kernel's tiling: 128 query rows, 64 keys a stage
    (1, 130, 200, 4, 2, 128, False, 0, torch.bfloat16),   # Sq != Sk, ragged
    (2, 200, 130, 4, 4, 64, True, 0, torch.bfloat16),     # causal, Sq > Sk
    (2, 100, 100, 4, 1, 256, True, 0, torch.bfloat16),    # causal, Sq < BQ
    (1, 300, 300, 4, 2, 128, True, 40, torch.bfloat16),   # window < a tile
    (1, 700, 700, 2, 1, 64, True, 200, torch.bfloat16),   # window > BQ
    (1, 257, 257, 4, 4, 256, True, 0, torch.bfloat16),    # GQA group of 1
    (4, 2048, 2048, 4, 1, 256, True, 0, torch.bfloat16),  # gemma3-1b global
    (1, 1000, 100, 2, 1, 128, True, 64, torch.bfloat16),  # row 163 on: no key
    (2, 77, 40, 4, 2, 64, False, 0, torch.bfloat16),      # Sk < one tile
]


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_vs_plain(cuda, case):
    b, sq, sk, h, kv, d, causal, window, dtype = case
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    q = torch.randn((b, sq, h, d), device=cuda, generator=g).to(dtype)
    k = torch.randn((b, sk, kv, d), device=cuda, generator=g).to(dtype)
    v = torch.randn((b, sk, kv, d), device=cuda, generator=g).to(dtype)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    atol, row_tol = (0.06, 0.1) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err
    row = row_error(got, want)
    assert row <= row_tol, row


@pytest.mark.parametrize("case", [(2, 333, 4, 1, 256, True, 0),
                                  (1, 200, 8, 2, 128, True, 64),
                                  (2, 150, 2, 2, 64, False, 0)])
def test_flash_attention_kernel_reads_strided_views(cuda, case):
    """q, k and v sliced from one (B, S, H + 2 KV, D) tensor, as a fused
    QKV projection gives them: the kernel reads their real strides and
    gives what it gives on contiguous copies, bit for bit."""
    b, s, h, kv, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(s + d)
    qkv = torch.randn((b, s, h + 2 * kv, d), device=cuda,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    dense = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max().item() <= 0.06
    assert row_error(got, want) <= 0.1


def test_flash_attention_raises_on_unsupported_cuda_inputs(cuda):
    def qkv(d, dtype):
        return (torch.zeros((1, 8, 2, d), dtype=dtype, device=cuda),
                torch.zeros((1, 8, 1, d), dtype=dtype, device=cuda),
                torch.zeros((1, 8, 1, d), dtype=dtype, device=cuda))
    before = fa_ops.launches
    with pytest.raises(ValueError):
        fa_ops.flash_attention(*qkv(96, torch.bfloat16))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(*qkv(64, torch.float16))
    q, k, v = qkv(128, torch.bfloat16)
    strided = torch.zeros((1, 8, 1, 256), dtype=torch.bfloat16,
                          device=cuda)[..., ::2]
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, strided, v)
    # rows 260 elements (520 bytes) apart: TMA needs multiples of 16 bytes
    odd_rows = torch.zeros(8 * 260, dtype=torch.bfloat16,
                           device=cuda).as_strided((1, 8, 2, 128),
                                                   (8 * 260, 260, 128, 1))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(odd_rows, k, v)
    assert fa_ops.launches == before


def test_serving_path_launches_k4_per_layer(cuda):
    """A small dense model whose head_dim the kernel takes: K4 runs once
    per layer in prefill and never in decode; the CUDA logits (float32,
    so K4's float32 kernel) match the CPU's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3-1b"),
                              head_dim=64, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cpu_params = model.init(torch.Generator().manual_seed(0))
    cpu_params.load_state_dict(params.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    eng, ceng = ServeEngine(model, params, 56), ServeEngine(model,
                                                            cpu_params, 56)
    before = fa_ops.launches
    st = eng.prefill({"tokens": tokens.to(cuda)})
    assert fa_ops.launches - before == cfg.n_layers
    toks, _ = eng.generate(st, 8)
    torch.cuda.synchronize()
    assert fa_ops.launches - before == cfg.n_layers
    ctoks, _ = ceng.generate(ceng.prefill({"tokens": tokens}), 8)
    assert torch.equal(toks.cpu(), ctoks)


# ----------------------------------------------- K4 with kv_len (encdec)
FA_KV_CASES = [  # B, Sq, Sk, H, KV, D, causal, kv_len, dtype
    # whisper's cross-attention: ragged within and across a 64-key tile,
    # one key, and kv_len = Sk
    (4, 224, 1500, 6, 6, 64, False, (1500, 1200, 700, 1), torch.bfloat16),
    (4, 130, 300, 4, 2, 128, False, (300, 64, 65, 63), torch.bfloat16),
    (3, 70, 200, 4, 4, 64, False, (200, 130, 5), torch.float32),
    (2, 65, 129, 2, 1, 128, False, (129, 100), torch.float32),
    (3, 300, 300, 4, 2, 128, True, (300, 190, 64), torch.bfloat16),
]


@pytest.mark.parametrize("case", FA_KV_CASES)
def test_flash_attention_kernel_kv_len_vs_plain(cuda, case):
    b, sq, sk, h, kv, d, causal, lens, dtype = case
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, sq, h, d), device=cuda, generator=g).to(dtype)
    k = torch.randn((b, sk, kv, d), device=cuda, generator=g).to(dtype)
    v = torch.randn((b, sk, kv, d), device=cuda, generator=g).to(dtype)
    kv_len = torch.tensor(lens, device=cuda)
    before = fa_ops.launches
    got, lse = fa_ops.flash_attention_with_lse(q, k, v, causal=causal,
                                               kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want, want_lse = flash_attention_ref(q, k, v, causal=causal,
                                         kv_len=kv_len, return_lse=True)
    atol, row_tol = (0.06, 0.1) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert row_error(got, want) <= row_tol
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL
    # the length matters: the same call without it is far off
    full = fa_ops.flash_attention(q, k, v, causal=causal)
    assert row_error(full, want) > 0.3


def test_flash_attention_kernel_whisper_encoder_with_zero_pad(cuda):
    """whisper-tiny's encoder shape (B 4, 1,500 frames, 6 heads of 64) as
    ``models/attention.bidirectional`` calls K4: 36 zero keys appended up
    to 1,536, which enter the softmax as the reference's do."""
    from repro_torch.models import attention as A
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((4, 1500, 6, 64), device=cuda, generator=g
                           ).to(torch.bfloat16) for _ in range(3))
    got = A.bidirectional(q, k, v, block=A.ENCODER_BLOCK)
    pad = torch.zeros((4, 36, 6, 64), dtype=torch.bfloat16, device=cuda)
    want = flash_attention_ref(q, torch.cat([k, pad], 1),
                               torch.cat([v, pad], 1), causal=False)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 0.06
    assert row_error(got, want) <= 0.1


def test_flash_attention_kv_len_checks_and_k4b_takes_it(cuda):
    """Both wrappers reject a kv_len outside [1, Sk] or off q's device
    before any launch; through autograd, kv_len reaches K4 and K4b (one
    launch each), and the gradients equal K4b called directly."""
    q = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((2, 16, 1, 64), dtype=torch.bfloat16, device=cuda)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    for bad in ((0, 16), (17, 1)):
        for fn in (lambda t: fa_ops.flash_attention(q, k, k, causal=False,
                                                    kv_len=t),
                   lambda t: fa_ops.flash_attention_bwd(
                       q, k, k, q, q, causal=False, kv_len=t)):
            with pytest.raises(ValueError, match="kv_len"):
                fn(torch.tensor(bad, device=cuda))
    with pytest.raises(ValueError, match="kv_len"):
        fa_ops.flash_attention(q, k, k, kv_len=torch.tensor([3, 3]))
    assert (fa_ops.launches, fa_ops.bwd_launches) == before
    g = torch.Generator(device=cuda).manual_seed(9)
    qg, kg, vg, do = (torch.randn(t.shape, device=cuda, generator=g).to(
        torch.bfloat16) for t in (q, k, k, q))
    for t in (qg, kg, vg):
        t.requires_grad_(True)
    kv_len = torch.tensor([16, 5], device=cuda)
    out = fa_ops.flash_attention(qg, kg, vg, causal=False, kv_len=kv_len)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    direct = fa_ops.flash_attention_bwd(
        qg.detach(), kg.detach(), vg.detach(), out.detach(), do,
        causal=False, kv_len=kv_len)
    assert all(torch.equal(a, b) for a, b in zip(grads, direct))
    assert torch.equal(grads[1][1, 5:], torch.zeros_like(grads[1][1, 5:]))


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-2b"])
def test_encdec_and_vlm_serve_on_the_card_equals_the_cpu(cuda, arch):
    """2 layers at the full width of ``arch`` in float32 (whisper: 2
    encoder and 2 decoder layers at enc_seq 1,500, so the zero pad is
    live, with ragged enc_len; qwen2-vl: M-RoPE components that differ),
    the same weights on the card and the CPU: prefill and decode logits
    within 1e-3 (float32 sums in other orders), tokens equal, K4 three
    times a decoder layer (encdec) or once (vlm) in prefill and never in
    decode."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    over = dict(n_layers=2, dtype="float32")
    if arch == "whisper-tiny":
        over["enc_layers"] = 2
    cfg = dataclasses.replace(configs.get_config(arch), **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cpu_params = copy.deepcopy(params).to("cpu")
    nb = shapes.prefill_batch_specs(cfg, 64, 4,
                                    rng=np.random.default_rng(1))
    if arch == "whisper-tiny":
        nb["enc_len"] = np.array([1500, 1200, 700, 1], np.int32)
        per_prefill = 3 * cfg.n_layers
    else:
        i = np.arange(64)
        nb["positions"] = np.stack([np.broadcast_to(i, (4, 64)),
                                    np.broadcast_to(i // 8, (4, 64)),
                                    np.broadcast_to(i % 8, (4, 64))]
                                   ).astype(np.int32)
        per_prefill = cfg.n_layers
    out = {}
    for dev, p in ((cuda, params), (torch.device("cpu"), cpu_params)):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in nb.items()}
        eng = ServeEngine(model, p, 64 + 16)
        before = fa_ops.launches
        st = eng.prefill(batch)
        logits, _ = model.prefill(p, batch, 64 + 16)
        n_pre = fa_ops.launches - before
        toks, _ = eng.generate(st, 6)
        out[dev.type] = (logits.cpu(), toks.cpu(), n_pre,
                         fa_ops.launches - before - n_pre)
    assert out["cuda"][2:] == (2 * per_prefill, 0)
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-3
    assert torch.equal(out["cuda"][1], out["cpu"][1])


# ------------------------------------------------------------ K4b (bwd)
# K4b against its plain version: dq, dk, dv each within a max abs error of
# K4B_REL times the largest |value| and a row error (rows' RMS floored at
# K4B_ROW_FLOOR times the tensor's, since a row of dQ can be 0 but for
# rounding, as query 0's is) of K4B_ROW_TOL.  bfloat16's floor is low, so
# that the small dK/dV rows of the last key tiles, which few queries see,
# are judged by their own RMS.  float32's limit is so tight that such a
# row dropped reads far beyond it at a floor of 1, while a lower floor
# would count the rounding noise of dQ's row 0 (~1e-5 of the tensor's
# RMS) as a fault.  bfloat16: the
# gradients are rounded to bfloat16 (one step is 2**-8 of a value up to ~4
# RMS), and the kernel holds P and dS in its products as bfloat16 pairs
# (hi + lo, about 16 bits); every sum is float32 in both.
K4B_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
K4B_ROW_TOL = {torch.bfloat16: 0.1, torch.float32: 1e-4}
K4B_ROW_FLOOR = {torch.bfloat16: 0.05, torch.float32: 1.0}

K4B_CASES = [  # B, Sq, Sk, H, KV, D, causal, window, dtype, kv_len
    (2, 1024, 1024, 4, 1, 256, True, 0, torch.bfloat16, None),  # gemma3
    (2, 1024, 1024, 4, 1, 256, True, 512, torch.bfloat16, None),  # local
    (1, 512, 512, 16, 8, 128, True, 0, torch.bfloat16, None),   # qwen3 GQA
    (2, 333, 333, 4, 2, 64, True, 40, torch.float32, None),     # ragged
    (1, 130, 200, 4, 4, 128, False, 0, torch.bfloat16, None),   # not causal
    (2, 100, 100, 4, 1, 256, True, 0, torch.float32, None),     # Sq < BQ
    (2, 333, 333, 4, 2, 64, True, 40, torch.bfloat16, None),    # D 64
    # not causal, window 16 over 64 keys: rows 79 to 199 see no key
    (1, 200, 64, 2, 1, 128, False, 16, torch.bfloat16, None),
    (1, 200, 64, 2, 1, 64, False, 16, torch.float32, None),
    # 33 key tiles: the dK/dV blocks' tile lookup takes two warp passes
    (1, 2100, 2100, 4, 2, 128, True, 0, torch.bfloat16, None),
    # kv_len: whisper-tiny's cross-attention in training (448 decoder
    # tokens over 1,500 frames, D 64; Sk not a multiple of 64), ragged
    # within and across a 64-key tile and down to one key
    (4, 448, 1500, 6, 6, 64, False, 0, torch.bfloat16, (1500, 1200, 700, 1)),
    (3, 130, 200, 4, 2, 128, False, 0, torch.bfloat16, (200, 65, 1)),
    # float32 at one key is left out: that key's dK row is 0 in exact
    # arithmetic, so both versions give rounding noise there (the plain
    # float32 row is 5.9e-5 off float64's, beside K4B_ROW_TOL 1e-4)
    (3, 70, 200, 4, 4, 64, False, 0, torch.float32, (200, 130, 5)),
    (3, 300, 300, 4, 2, 128, True, 0, torch.bfloat16, (300, 190, 64)),
]
# the rows of K4B_CASES with a kv_len
K4B_KV_CASES = [c for c in K4B_CASES if c[9] is not None]
# K4's lse against the plain lse: float32 sums of up to 1,024 exponentials
# in another order, and in bfloat16 the special-function unit's exp2 and
# log2 (relative error about 2**-22), on values up to ~10: a few 1e-6.  A
# row with no live key must be +inf in both.
LSE_ATOL = 1e-4


def _k4b_inputs(case, cuda):
    """q, k, v, K4's output and lse (the forward that autograd saves), dO,
    and the call's keywords (causal, window, kv_len)."""
    b, sq, sk, h, kv, d, causal, window, dtype, lens = case
    g = torch.Generator(device=cuda).manual_seed(sq + d + window)
    q, do = (torch.randn((b, sq, h, d), device=cuda, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, sk, kv, d), device=cuda, generator=g).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window,
              kv_len=None if lens is None else torch.tensor(
                  lens, dtype=torch.int32, device=cuda))
    o, lse = fa_ops.flash_attention_with_lse(q, k, v, **kw)
    return q, k, v, o, lse, do, kw


def _k4b_ok(got, want, dtype):
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == dtype and a.shape == w.shape
        err = (a.float() - w.float()).abs().max().item()
        if err > K4B_REL[dtype] * w.float().abs().max().item():
            return False
        if row_error(a, w, floor=K4B_ROW_FLOOR[dtype]) > K4B_ROW_TOL[dtype]:
            return False
    return True


@pytest.mark.parametrize("case", K4B_CASES)
def test_flash_attention_lse_kernel_vs_plain(cuda, case):
    """K4's lse (the forward K4b reads) against the plain lse, LSE_ATOL;
    its output is the same with and without lse."""
    q, k, v, o, lse, _, kw = _k4b_inputs(case, cuda)
    _, want = flash_attention_ref(q, k, v, return_lse=True, **kw)
    plain_o = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    live = torch.isfinite(want)
    assert (lse[live] - want[live]).abs().max().item() <= LSE_ATOL
    assert torch.all(lse[~live] == torch.inf)
    assert torch.equal(o, plain_o)


@pytest.mark.parametrize("case", K4B_CASES)
def test_flash_attention_bwd_kernel_vs_plain(cuda, case):
    dtype = case[8]
    q, k, v, o, lse, do, kw = _k4b_inputs(case, cuda)
    before = fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    assert _k4b_ok(got, want, dtype)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", K4B_KV_CASES)
def test_flash_attention_bwd_kv_len_rows_past_are_zero(cuda, case):
    """The dK and dV rows of the keys at or past a row's kv_len are
    exactly 0 (the plain backward's are), in the tile that straddles it
    and in the tiles past it.  In bfloat16, a batch row with one live key
    has dS = 0 exactly (its Delta is the same tensor-core sum as dP), so
    its dQ and that key's dK are exactly 0, as in exact arithmetic."""
    q, k, v, o, lse, do, kw = _k4b_inputs(case, cuda)
    dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    _, wk, wv = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for bi, n in enumerate(kw["kv_len"].tolist()):
        for got, want in ((dk, wk), (dv, wv)):
            assert torch.equal(want[bi, n:], torch.zeros_like(want[bi, n:]))
            assert torch.equal(got[bi, n:], want[bi, n:])
        assert dv[bi, :n].abs().max().item() > 0
        if n == 1 and q.dtype == torch.bfloat16:
            assert dq[bi].count_nonzero().item() == 0
            assert dk[bi, 0].count_nonzero().item() == 0


@pytest.mark.parametrize("fault, tile", [(1, 1), (2, 1), (1, -1), (3, 1),
                                         (4, 0)],
                         ids=["1", "2", "1-last", "3-lse", "4-kv_len"])
def test_flash_attention_bwd_planted_faults_fail(cuda, fault, tile):
    """Key tile 1 or the last key tile dropped from the dK/dV loop, Delta
    left out of dS, or each row's lse read from the next row, fails the
    check above: gemma3-1b's two layer kinds in bfloat16 and the two
    float32 cases.  kv_len ignored in the dK/dV walk fails it on every
    kv_len case."""
    cases = (K4B_KV_CASES if fault == 4 else
             (*K4B_CASES[:2], K4B_CASES[3], K4B_CASES[5]))
    for case in cases:
        dtype = case[8]
        q, k, v, o, lse, do, kw = _k4b_inputs(case, cuda)
        before = fa_ops.bwd_launches
        got = fa_ops.flash_attention_bwd_planted(
            q, k, v, o, do, fault=fault, tile=tile, lse=lse, **kw)
        assert fa_ops.bwd_launches == before
        want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
        assert not _k4b_ok(got, want, dtype)


def test_flash_attention_autograd_launches_k4_and_k4b(cuda):
    """Through autograd on the card: one K4 launch forward (writing lse),
    one K4b launch backward, gradients equal to the kernel called directly
    (which, given no lse, has K4 write it first)."""
    q, k, v, _, _, do, _ = _k4b_inputs(K4B_CASES[2], cuda)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    out = fa_ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    direct = fa_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                        out.detach(), do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(grads, direct))


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """Two train steps of a small float32 dense model whose head_dim the
    kernels take (K4 forward and recompute, K4b backward, remat "dots"):
    losses and parameters as on the CPU.  float32: 1e-4 (sums in other
    orders through a few layers and two AdamW steps)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as topt
    from repro_torch.train import tree as T
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3-1b"),
                              head_dim=64, dtype="float32", remat="dots")
    model = build_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 41)).astype(np.int32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = model.init(torch.Generator().manual_seed(0))
        params = params.to(dev)
        tr = Trainer(model, topt.OptConfig(lr=1e-3, warmup_steps=0),
                     TrainerConfig(steps=2, log_every=1))
        before = (fa_ops.launches, fa_ops.bwd_launches)
        batch = {"tokens": toks[:, :-1].to(dev),
                 "targets": toks[:, 1:].to(dev)}
        params, _, hist = tr.fit(params, topt.init(params.tree()),
                                 iter([batch, batch]), resume=False)
        if dev.type == "cuda":
            n = cfg.n_layers * 2
            assert (fa_ops.launches - before[0],
                    fa_ops.bwd_launches - before[1]) == (2 * n, n)
        out[dev.type] = ([h["loss"] for h in hist],
                         [p.detach().cpu() for p in T.leaves(params.tree())])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------- moe, ssm and hybrid layers
def _moe_params(cfg, dev, seed=0):
    from repro_torch.models import moe
    return moe.moe_init(torch.Generator(device=dev).manual_seed(seed), cfg)


@pytest.mark.parametrize("factor", [None, 1.0], ids=["cf8", "cf1"])
def test_moe_apply_on_the_card_equals_the_cpu(cuda, factor):
    """qwen2-moe's smoke width in float32: the same experts chosen, the
    same assignments dropped (capacity factor 1.0), outputs within 1e-5,
    aux within 1e-6."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-moe-a2.7b"),
                              dtype="float32")
    p = _moe_params(cfg, cuda)
    cp = copy.deepcopy(p).cpu()
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator(
        ).manual_seed(1))
    got, aux = moe.moe_apply(p, cfg, x.to(cuda), capacity_factor=factor)
    want, caux = moe.moe_apply(cp, cfg, x, capacity_factor=factor)
    xt = x.reshape(-1, cfg.d_model)
    cap = moe.capacity_of(cfg, xt.shape[0], factor or
                          cfg.moe_capacity_factor)
    plans = []
    for params, t in ((p, xt.to(cuda)), (cp, xt)):
        _, _, top_e = moe.route(params, cfg, t)
        plans.append((top_e.cpu(),) + tuple(
            r.cpu() for r in moe.dispatch(top_e, params["up"].shape[0],
                                          cap)))
    for a, b in zip(*plans):
        assert torch.equal(a, b)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), caux, atol=1e-6, rtol=1e-6)


def test_moe_apply_bf16_on_the_card_is_deterministic(cuda):
    """Two bfloat16 runs at a full-width token count (qwen2-moe's smoke
    experts, 8,192 tokens) give the same bits: the combine adds in a fixed
    order, with no atomics."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-moe-a2.7b"),
                              moe_capacity_factor=1.25)
    p = _moe_params(cfg, cuda)
    x = torch.randn((4, 2048, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2)
                    ).to(torch.bfloat16)
    a = moe.moe_apply(p, cfg, x)
    b = moe.moe_apply(p, cfg, x)
    assert a[0].dtype == torch.bfloat16
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("s", [256, 200])
def test_ssd_chunked_on_the_card_equals_the_cpu(cuda, s):
    """mamba2's chunk 128 over one and a half and two chunks, float32:
    1e-5 relative to the largest |value| (sums in other orders)."""
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(s)
    xh = torch.randn((2, s, 4, 16), generator=g)
    dt = torch.rand((2, s, 4), generator=g) * 0.1
    a = -torch.linspace(0.5, 2.0, 4)
    bm, cm = (torch.randn((2, s, 32), generator=g) for _ in range(2))
    want = ssm.ssd_chunked(xh, dt, a, bm, cm, chunk=128)
    got = ssm.ssd_chunked(*(t.to(cuda) for t in (xh, dt, a, bm, cm)),
                          chunk=128)
    for x, w in zip(got, want):
        scale = w.abs().max().item()
        torch.testing.assert_close(x.cpu(), w, atol=1e-5 * scale, rtol=0)


def test_rglru_scan_on_the_card_equals_the_cpu(cuda):
    """The log-depth scan at recurrentgemma's width over 4,096 steps,
    float32: 1e-5 relative to the largest |value|."""
    from repro_torch.models import rglru
    g = torch.Generator().manual_seed(0)
    a = torch.rand((1, 4096, 4096), generator=g) * 0.5 + 0.5
    b = torch.randn((1, 4096, 4096), generator=g)
    want = rglru.linear_scan(a, b)
    got = rglru.linear_scan(a.to(cuda), b.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                               rtol=0)


# ------------------------------------------------------- fabric and MPI
def test_prng_draws_on_the_card_equal_the_cpu(cuda):
    from repro_torch.net import prng
    for dev_key in (prng.PRNGKey(11, cuda), prng.split(
            prng.PRNGKey(3, cuda), 8)):
        cpu_key = dev_key.cpu()
        assert torch.equal(prng.split(dev_key, 4).cpu(),
                           prng.split(cpu_key, 4))
        for size in (1, 64, 4096):
            assert torch.equal(prng.uniform(dev_key, (size,)).cpu().view(
                torch.int32), prng.uniform(cpu_key, (size,)).view(
                torch.int32))
            assert torch.equal(prng.randint(dev_key, (size,), 0, 3).cpu(),
                               prng.randint(cpu_key, (size,), 0, 3))


def _slmp_fabric(device):
    from repro_torch import net
    msg = np.random.default_rng(0).integers(0, 256, 20_000).astype(np.uint8)
    cfg = slmp.SlmpSenderConfig(window=8, mtu_payload=1024, timeout=10,
                                src_mac=pkt.node_mac(0),
                                dst_mac=pkt.node_mac(1))
    sender = net.SlmpSenderEngine(msg, msg_id=42, cfg=cfg)
    a = net.Node("sender", pkt.node_mac(0), [apps.make_null_context()],
                 engines=[sender], batch=16, device=device)
    b = net.Node("recv", pkt.node_mac(1), [slmp.make_slmp_context()],
                 batch=16, host_bytes=1 << 17, device=device)
    fab = net.Fabric([a, b], link_cfg=net.LinkConfig(loss=0.1, latency=2,
                                                     jitter=2),
                     seed=7, device=device)
    return fab, sender, b, msg


def test_lossy_slmp_fabric_on_the_card_equals_the_cpu(cuda):
    """Loss 0.1, jitter 2: tick for tick, the card's link states equal the
    CPU's; the K1 launches are the busy node-ticks."""
    gfab, gsender, gb, msg = _slmp_fabric(cuda)
    cfab, csender, cb, _ = _slmp_fabric("cpu")
    assert gfab._stack.data.device.type == "cuda"
    before = match_ops.launches
    for _ in range(3000):
        gt, ct = gfab.run(max_ticks=1), cfab.run(max_ticks=1)
        assert gt == ct
        if gt == 0:
            break
        for a, b in zip(gfab._per_link_states(), cfab._per_link_states()):
            ga, cb_ = a.to_numpy(), b.to_numpy()
            for k in ga:
                np.testing.assert_array_equal(ga[k], cb_[k], err_msg=k)
    assert gfab.now == cfab.now and gfab.stats() == cfab.stats()
    assert gsender.sender.retransmits == csender.sender.retransmits > 0
    np.testing.assert_array_equal(gb.read_host(0, len(msg)), msg)
    assert match_ops.launches - before == sum(n.steps for n in gfab.nodes)
    assert gb.state.l2.device.type == "cuda"


def test_rendezvous_nic_unpack_on_the_card_equals_the_cpu(cuda):
    from repro_torch import mpi, net
    outs = []
    for device in (cuda, "cpu"):
        reg = mpi.DatatypeRegistry()
        cid = reg.register(ddt.complex_ddt(), count=64, name="complex")
        comm = mpi.Communicator(2, registry=reg, seed=0, device=device,
                                link_cfg=net.LinkConfig(loss=0.05, latency=2,
                                                        jitter=2))
        c = reg.committed(cid)
        mem = np.random.default_rng(1).integers(0, 256, c.mem_bytes).astype(
            np.uint8)
        buf = np.zeros(c.mem_bytes, np.uint8)
        r = comm.irecv(1, buf, source=0, tag=1)
        s = comm.isend(0, 1, mem, tag=1, datatype=cid)
        comm.wait(r, s)
        np.testing.assert_array_equal(
            buf, ddt.unpack_np(c, ddt.pack_np(c, mem),
                               np.zeros(c.mem_bytes, np.uint8)))
        outs.append((buf, comm.now, comm.stats(), comm.link_stats()))
        assert comm.nic.device.type == torch.device(device).type
    (gbuf, *gmeta), (cbuf, *cmeta) = outs
    np.testing.assert_array_equal(gbuf, cbuf)
    assert gmeta == cmeta


def test_k4_k4b_through_dtensor_on_a_one_rank_nccl_mesh(cuda):
    """The mesh path's attention on the card: DTensor q, k, v on a
    one-rank NCCL (data, model) mesh, split by batch (and heads, over a
    model axis of 1), run K4 and K4b on their local shards: the output
    and the gradients equal the plain-tensor calls bit for bit, placed
    like the inputs, and each launch counter grows by 1, as it does for
    the plain call (a fallback to the plain version would not count)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator(device=cuda).manual_seed(0)
        q, do = (torch.randn((2, 256, 4, 128), generator=g, device=cuda,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((2, 256, 1, 128), generator=g, device=cuda,
                            dtype=torch.bfloat16) for _ in range(2))
        runs = []
        for dtensor in (False, True):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            args = ins
            if dtensor:
                args = [distribute_tensor(t.detach(), mesh,
                                          [Shard(0), Shard(2)]
                                          ).requires_grad_(True)
                        for t in ins]
            n4, n4b = fa_ops.launches, fa_ops.bwd_launches
            out = fa_ops.flash_attention(*args, causal=True, window=0)
            grads = torch.autograd.grad(
                out, args, distribute_tensor(do, mesh, [Shard(0), Shard(2)])
                if dtensor else do)
            torch.cuda.synchronize()
            assert (fa_ops.launches - n4, fa_ops.bwd_launches - n4b) == \
                (1, 1)
            if dtensor:
                assert isinstance(out, DTensor)
                assert list(out.placements) == [Shard(0), Shard(2)]
                assert all(list(x.placements) == [Shard(0), Shard(2)]
                           for x in grads)
                out, grads = out.to_local(), [x.to_local() for x in grads]
            runs.append((out, grads))
        (o1, g1), (o2, g2) = runs
        assert torch.equal(o1, o2)
        for a, b in zip(g1, g2):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("window", [0, 512], ids=["global", "local"])
def test_k4_k4b_custom_ops_equal_the_direct_launches(cuda, window):
    """K4 and K4b go through ``torch.library`` custom ops (so that a
    dispatch mode counts them): at gemma3-1b's shape (B 4, S 1,024, H 4
    over KV 1, D 256, bfloat16) the ops' outputs, lse and gradients equal
    the launchers called directly, bit for bit, each one launch; under
    the counting mode one call each, with 4 D and 10 D FLOPs a live pair
    and head."""
    from repro_torch.launch.roofline import CountingMode
    g = torch.Generator(device=cuda).manual_seed(4)
    q, do = (torch.randn((4, 1024, 4, 256), generator=g, device=cuda,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((4, 1024, 1, 256), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    n4, n4b = fa_ops.launches, fa_ops.bwd_launches
    with CountingMode() as m:
        out, lse = torch.ops.repro.flash_attention(q, k, v, None, True,
                                                   window, True)
        grads = torch.ops.repro.flash_attention_bwd(q, k, v, out, do, lse,
                                                    None, True, window)
    d_out, d_lse = fa_ops._launch(q, k, v, True, window, None, True)
    direct = fa_ops._bwd_launch(q, k, v, d_out, do, True, window, (), d_lse,
                                None)
    torch.cuda.synchronize()
    assert (fa_ops.launches - n4, fa_ops.bwd_launches - n4b) == (2, 2)
    assert torch.equal(out, d_out) and torch.equal(lse, d_lse)
    assert all(torch.equal(a, b) for a, b in zip(grads, direct))
    pairs = 4 * fa_ops.live_pairs(1024, 1024, True, window)
    assert m.calls == {"repro::flash_attention": 1,
                       "repro::flash_attention_bwd": 1}
    assert m.flops == 14 * 256 * 4 * pairs


# ------------------------------------------------ K5: the SSD decode mixer
K5_PARAMS = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm")
K5_CASES = [  # config, batch, dtype
    ("mamba2-780m", 16, "bfloat16"),        # a layer of the serve cell
    ("mamba2-780m", 3, "float32"),
    ("mamba2-smoke", 3, "bfloat16"),
    ("mamba2-smoke", 1, "float32"),
]
# K5 against its plain version on the card, over 4 steps that carry the
# state.  The conv window is data movement: exact.  The output, by
# ``row_error`` (a row's largest error over its RMS): the sums over the
# state (N terms) and the norm's over d_inner run in another order, and
# the conv's 4 taps too; in bfloat16 that moves a rounding to bfloat16 by
# one step (2**-8 of a value) now and then, which the gate, the norm and
# the next steps carry: a few hundredths of a row's RMS at most; float32
# about 1e-6.  The state, by its largest error over its largest |value|:
# a conv output one bfloat16 step apart moves that element's update by
# 2**-8 of it, so 1e-2 in bfloat16; float32 1e-5.
K5_ROW_TOL = {"bfloat16": 0.1, "float32": 1e-4}
K5_STATE_REL = {"bfloat16": 1e-2, "float32": 1e-5}


def ssm_decode_inputs(cfg, batch, seed, steps=4):
    """A mamba2 decode layer on the CPU, from ``seed``: its parameters
    (``ssm_init``, with the conv bias, norm scale and D drawn away from
    their constant initial values), caches holding a random window and
    state, and ``steps`` inputs (steps, B, 1, d_model)."""
    from repro_torch.models import layers, ssm
    dt = layers.dtype_of(cfg.dtype)
    g = torch.Generator().manual_seed(seed)
    p = {k: v.detach() for k, v in ssm.ssm_init(g, cfg).items()}
    p["conv_b"] = (0.2 * torch.randn(p["conv_b"].shape, generator=g)).to(dt)
    p["norm"] = (1 + 0.2 * torch.randn(p["norm"].shape, generator=g)).to(dt)
    p["d_skip"] = 1 + 0.2 * torch.randn(p["d_skip"].shape, generator=g)
    cache = ssm.ssm_decode_init(cfg, batch, dt, "cpu")
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=g))
    cache["ssd"].copy_(0.5 * torch.randn(cache["ssd"].shape, generator=g))
    x = torch.randn((steps, batch, 1, cfg.d_model), generator=g).to(dt)
    return p, cache, x


def k5_args(p, cache, x):
    """The mixer's arguments for one step of input x (B, 1, d_model)."""
    return ((x @ p["in_proj"])[:, 0], cache["conv"], cache["ssd"],
            *(p[k] for k in K5_PARAMS))


def k5_cfg(name, dtype):
    import dataclasses
    from repro_torch import configs
    cfg = (configs.get_smoke_config("mamba2-780m") if name == "mamba2-smoke"
           else configs.get_config(name))
    return dataclasses.replace(cfg, dtype=dtype)


def _k5_steps(cfg, batch, seed, device, mixer):
    """Each step's (output, conv window, state) through ``mixer``."""
    p, cache, xs = ssm_decode_inputs(cfg, batch, seed)
    p = {k: v.to(device) for k, v in p.items()}
    cache = {k: v.to(device) for k, v in cache.items()}
    out = []
    for x in xs.to(device):
        y = mixer(*k5_args(p, cache, x), cfg.norm_eps)
        out.append((y, cache["conv"].clone(), cache["ssd"].clone()))
    return out


def _k5_errors(got, want):
    """Per step: (row error of the output, conv window equal, the state's
    largest error over its largest |value|)."""
    return [(row_error(g[0], w[0]), torch.equal(g[1], w[1]),
             ((g[2] - w[2]).abs().max() / w[2].abs().max()).item())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", K5_CASES, ids=lambda c: str(c))
def test_ssm_decode_kernel_vs_plain(cuda, case):
    """K5 and its plain version on the card from the same layer and
    caches, 4 steps each: two launches a step; tolerances at
    ``K5_ROW_TOL``."""
    name, batch, dtype = case
    cfg = k5_cfg(name, dtype)
    want = _k5_steps(cfg, batch, 1, cuda, ssm_decode_mixer_ref)
    before = k5_ops.launches
    got = _k5_steps(cfg, batch, 1, cuda, k5_ops.ssm_decode_mixer)
    torch.cuda.synchronize()
    assert k5_ops.launches - before == 2 * len(want)
    for step, (row, conv, state) in enumerate(_k5_errors(got, want)):
        assert got[step][0].dtype == want[step][0].dtype
        assert conv, f"step {step}: conv window"
        assert row <= K5_ROW_TOL[dtype], f"step {step}: row error {row}"
        assert state <= K5_STATE_REL[dtype], f"step {step}: state {state}"


@pytest.mark.parametrize("fault", [1, 2, 3])
@pytest.mark.parametrize("case", [K5_CASES[0], K5_CASES[3]],
                         ids=lambda c: str(c))
def test_ssm_decode_planted_faults_fail(cuda, case, fault):
    """Each planted fault fails the check that the sound kernel passes:
    1 (each head's last state row left as it was) the state's, 2 (the B/C
    channels' window left unshifted) the conv window's, 3 (y's D x skip
    left out) the output's."""
    name, batch, dtype = case
    cfg = k5_cfg(name, dtype)
    want = _k5_steps(cfg, batch, 1, cuda, ssm_decode_mixer_ref)
    got = _k5_steps(cfg, batch, 1, cuda, lambda *a: (
        k5_ops.ssm_decode_mixer_planted(*a, fault=fault)))
    errs = _k5_errors(got, want)
    if fault == 1:
        assert max(e[2] for e in errs) > K5_STATE_REL[dtype], errs
    elif fault == 2:
        assert not all(e[1] for e in errs), errs
    else:
        assert max(e[0] for e in errs) > K5_ROW_TOL[dtype], errs


def test_ssm_decode_raises_on_shapes_the_kernel_does_not_take(cuda):
    """On CUDA a head dim that is not a power of two from 4 to 1,024, and
    float16, raise naming what they are."""
    import dataclasses
    cfg = dataclasses.replace(k5_cfg("mamba2-smoke", "float32"),
                              ssm_head_dim=6, d_inner=48)
    p, cache, xs = ssm_decode_inputs(cfg, 2, 0)
    p = {k: v.to(cuda) for k, v in p.items()}
    cache = {k: v.to(cuda) for k, v in cache.items()}
    with pytest.raises(ValueError, match="head dim 6"):
        k5_ops.ssm_decode_mixer(*k5_args(p, cache, xs[0].to(cuda)), 1e-5)
    cfg = k5_cfg("mamba2-smoke", "float32")
    p, cache, xs = ssm_decode_inputs(cfg, 2, 0)
    half = {k: v.to(cuda, torch.float16) for k, v in p.items()}
    for k in ("dt_bias", "a_log", "d_skip"):
        half[k] = p[k].to(cuda)
    cache = {"conv": cache["conv"].to(cuda, torch.float16),
             "ssd": cache["ssd"].to(cuda)}
    with pytest.raises(ValueError, match="float16"):
        k5_ops.ssm_decode_mixer(
            *k5_args(half, cache, xs[0].to(cuda, torch.float16)), 1e-5)


def test_serving_path_launches_k5_per_layer(cuda):
    """mamba2-smoke served on the card (float32): K5 twice a layer in each
    decode step and never in the prefill; the greedy tokens equal the
    CPU's."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = k5_cfg("mamba2-smoke", "float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cpu_params = model.init(torch.Generator().manual_seed(0))
    cpu_params.load_state_dict(params.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 20)))
    eng, ceng = ServeEngine(model, params, 32), ServeEngine(model,
                                                            cpu_params, 32)
    before = k5_ops.launches
    st = eng.prefill({"tokens": tokens.to(cuda)})
    assert k5_ops.launches == before
    toks, _ = eng.generate(st, 8)
    torch.cuda.synchronize()
    assert k5_ops.launches - before == 7 * 2 * cfg.n_layers
    ctoks, _ = ceng.generate(ceng.prefill({"tokens": tokens}), 8)
    assert torch.equal(toks.cpu(), ctoks)
