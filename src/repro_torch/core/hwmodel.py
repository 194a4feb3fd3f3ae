"""Analytic FPsPIN hardware timing model (paper Tables I–II, Fig 7); a copy
of ``repro.core.hwmodel`` (plain Python, no framework).

Its constants are the paper's FPGA figures (the 40 MHz HPU clock, the
250 MHz Corundum domain, Table II's cycle counts), not a TPU's and not a
GPU's: nothing here describes the device the port runs on.

The FPGA artifacts (40 MHz HPU clock, 250 MHz Corundum domain, module
latencies) are not portable to this substrate, so the *paper-faithful*
latency numbers are reproduced through a structural analytic model built
from the published constants.  Magnitude parameters are calibrated once
against Fig 7 (documented below); all *shapes* — the linear ICMP slope,
the flat UDP curves, the Host/FPsPIN orderings, the ingress-DMA range of
Table II — emerge from the model structure, not from fitting curves.

Units: nanoseconds unless suffixed otherwise.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------- constants
FPSPIN_CLK_HZ = 40e6          # application block clock (paper §IV-A)
CORUNDUM_CLK_HZ = 250e6       # Corundum native clock
WIRE_GBPS = 100.0             # QSFP 100G loopback

CYC = 1e9 / FPSPIN_CLK_HZ     # 25 ns per FPsPIN cycle
CCYC = 1e9 / CORUNDUM_CLK_HZ  # 4 ns per Corundum cycle

# Table II (measured from RTL state machines)
MATCH_CYCLES = 4              # -> 100 ns
ALLOC_CYCLES = 0
HER_CYCLES = 0
INGRESS_DMA_CYCLES_MIN = 8    # 64 B packet  -> 200 ns
INGRESS_DMA_CYCLES_MAX = 70   # 1536 B packet -> 1750 ns
HOST_DMA_NS = 450             # PCIe path, 250 MHz domain

# Calibration (Fig 7 magnitudes; see docstring):
CORUNDUM_PIPELINE_NS = 2_000        # MAC+PHY+ingress pipeline, per direction
HANDLER_BASE_CYCLES = 600           # handler dispatch + header rewrite
FPSPIN_CHECKSUM_CYC_PER_BYTE = 2.0  # portable-C csum on a 40 MHz HPU
HOST_CHECKSUM_SPEEDUP = 2.0         # paper: FPsPIN core only 2x slower
HOST_KERNEL_STACK_NS = 25_000       # interrupt + kernel ICMP responder
HOST_UDP_EXTRA_NS = 40_000          # paper: UDP stack + user-space ~40 us
HOST_NIC_IRQ_NS = 10_000            # NIC->host wakeup


def wire_ns(nbytes: int) -> float:
    return nbytes * 8 / WIRE_GBPS


def ingress_dma_ns(nbytes: int) -> float:
    """Linear in packet size between the Table II endpoints."""
    frac = min(max((nbytes - 64) / (1536 - 64), 0.0), 1.0)
    cyc = INGRESS_DMA_CYCLES_MIN + frac * (
        INGRESS_DMA_CYCLES_MAX - INGRESS_DMA_CYCLES_MIN)
    return cyc * CYC


def match_ns() -> float:
    return MATCH_CYCLES * CYC


def handler_ns(payload: int, checksum: bool) -> float:
    c = HANDLER_BASE_CYCLES
    if checksum:
        c += FPSPIN_CHECKSUM_CYC_PER_BYTE * payload
    return c * CYC


def host_checksum_ns(payload: int) -> float:
    return FPSPIN_CHECKSUM_CYC_PER_BYTE * payload * CYC / \
        HOST_CHECKSUM_SPEEDUP


@dataclasses.dataclass
class RTTBreakdown:
    total_ns: float
    parts: dict


def pingpong_rtt_ns(mode: str, proto: str, payload: int) -> RTTBreakdown:
    """Median RTT model for Fig 7.

    mode  : 'host' | 'fpspin' | 'host+fpspin'
    proto : 'icmp' | 'udp'
    """
    frame = 42 + payload if proto == "icmp" else 42 + payload
    parts = {"wire": 2 * wire_ns(frame),
             "corundum": 2 * CORUNDUM_PIPELINE_NS}
    if mode == "host":
        parts["nic_to_host"] = HOST_DMA_NS + HOST_NIC_IRQ_NS
        parts["host_stack"] = HOST_KERNEL_STACK_NS
        if proto == "udp":
            # responder in user space: stack traversal + context switch
            parts["udp_stack"] = HOST_UDP_EXTRA_NS
        # kernel checksum is vectorized — negligible slope
        parts["host_to_nic"] = HOST_DMA_NS
    elif mode == "fpspin":
        parts["match"] = match_ns()
        parts["ingress_dma"] = ingress_dma_ns(frame)
        parts["handler"] = handler_ns(frame - 34, checksum=proto == "icmp")
        parts["egress_dma"] = ingress_dma_ns(frame)
    elif mode == "host+fpspin":
        parts["match"] = match_ns()
        parts["ingress_dma"] = ingress_dma_ns(frame)
        parts["handler"] = handler_ns(0, checksum=False)
        parts["host_dma"] = 2 * HOST_DMA_NS           # to host and back
        if proto == "icmp":
            parts["host_csum"] = host_checksum_ns(frame - 34)
        parts["egress_dma"] = ingress_dma_ns(frame)
    else:
        raise ValueError(mode)
    return RTTBreakdown(total_ns=sum(parts.values()), parts=parts)


def table2() -> dict:
    """Reproduce paper Table II verbatim from the model constants."""
    return {
        "matching_engine": {"cycles": MATCH_CYCLES, "mhz": 40,
                            "ns": MATCH_CYCLES * CYC},
        "allocator": {"cycles": ALLOC_CYCLES, "mhz": 40, "ns": 0.0},
        "ingress_dma": {"cycles": (INGRESS_DMA_CYCLES_MIN,
                                   INGRESS_DMA_CYCLES_MAX), "mhz": 40,
                        "ns": (ingress_dma_ns(64), ingress_dma_ns(1536))},
        "her_generator": {"cycles": HER_CYCLES, "mhz": 40, "ns": 0.0},
        "host_dma": {"cycles": None, "mhz": 250, "ns": HOST_DMA_NS},
    }


def slmp_goodput_gbps(window: int, mtu_payload: int = 1484,
                      rtt_ns: float = 30_000,
                      recv_pkt_ns: float = 2_600,
                      recv_buf_pkts: int = 170) -> tuple:
    """Fig 8 model: windowed sender over a 100G loop.

    Sender pushes `window` segments then waits for the window's ACKs.
    Receiver drains one segment per `recv_pkt_ns` (ingress DMA + handler +
    host DMA, ~2.6 us for MTU frames).  Goodput saturates at the receiver
    rate; when the in-flight window exceeds the large-slot FIFO depth
    (170 slots, Table I-derived), allocation fails and transfers start
    failing — returns (gbps, fail_probability).
    """
    seg_wire = wire_ns(mtu_payload + 52)
    window_time = max(window * seg_wire, window * recv_pkt_ns) + rtt_ns
    gbps = window * mtu_payload * 8 / window_time
    overflow = max(0.0, (window - recv_buf_pkts) / max(window, 1))
    fail_p = min(1.0, 3.0 * overflow)
    return gbps, fail_p
