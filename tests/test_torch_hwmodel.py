"""The PyTorch port's copy of ``core/hwmodel.py`` (the paper's FPGA timing
model, plain Python) against the JAX package's: every result exactly
equal (the same float operations in the same order)."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import hwmodel as jhw  # noqa: E402
from repro_torch.core import hwmodel as thw  # noqa: E402

PAYLOADS = list(range(0, 1473, 8)) + [1, 17, 63, 64, 65, 1471, 1472]


@pytest.mark.parametrize("mode", ["host", "fpspin", "host+fpspin"])
@pytest.mark.parametrize("proto", ["icmp", "udp"])
def test_pingpong_rtt_equals_jax(mode, proto):
    for n in PAYLOADS:
        j = jhw.pingpong_rtt_ns(mode, proto, n)
        t = thw.pingpong_rtt_ns(mode, proto, n)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (mode, n)


def test_pingpong_rejects_an_unknown_mode_like_jax():
    for mod in (jhw, thw):
        with pytest.raises(ValueError):
            mod.pingpong_rtt_ns("nic", "udp", 64)


def test_table2_equals_jax():
    assert thw.table2() == jhw.table2()


def test_ingress_dma_and_stages_equal_jax():
    for n in range(0, 1700):
        assert thw.ingress_dma_ns(n) == jhw.ingress_dma_ns(n)
        assert thw.wire_ns(n) == jhw.wire_ns(n)
        assert thw.host_checksum_ns(n) == jhw.host_checksum_ns(n)
        for csum in (False, True):
            assert thw.handler_ns(n, csum) == jhw.handler_ns(n, csum)
    assert thw.match_ns() == jhw.match_ns()


def test_slmp_goodput_equals_jax():
    for w in range(1, 513):
        assert thw.slmp_goodput_gbps(w) == jhw.slmp_goodput_gbps(w)
        assert thw.slmp_goodput_gbps(w, mtu_payload=512, rtt_ns=12_000) \
            == jhw.slmp_goodput_gbps(w, mtu_payload=512, rtt_ns=12_000)


def test_constants_are_the_papers():
    names = [n for n in dir(jhw) if n.isupper()]
    assert names and all(getattr(thw, n) == getattr(jhw, n) for n in names)
    assert thw.FPSPIN_CLK_HZ == 40e6
