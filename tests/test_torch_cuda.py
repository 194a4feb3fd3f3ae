"""The PyTorch port on an NVIDIA GPU: the CUDA kernels K1 (matcher) and K2
(DDT gather) against their plain versions, and ``SpinNIC.step`` /
``SpinIngest`` on CUDA against the same calls on the CPU.  Tolerance:
exact (0); K2 compares bit patterns.

Every test here is marked ``cuda`` and skips where torch.cuda is not
available.  This file imports nothing of JAX, so it also runs on a machine
with only PyTorch:  PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import apps, ddt, packet as pkt, slmp  # noqa: E402
from repro_torch.core import matching, overlap, spin_nic  # noqa: E402
from repro_torch.kernels.ddt import ops as ddt_ops  # noqa: E402
from repro_torch.kernels.ddt.ref import ddt_gather_ref  # noqa: E402
from repro_torch.kernels.matcher import ops as match_ops  # noqa: E402
from repro_torch.kernels.matcher.ref import match_ref  # noqa: E402
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
    raw = pipe.packets_for_step(1)
    m, g = match_ops.launches, ddt_ops.launches
    got = gi(raw)
    assert (match_ops.launches - m, ddt_ops.launches - g) == (1, 2)
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
