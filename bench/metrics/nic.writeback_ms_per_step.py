"""Profiled host milliseconds (the profiler's cost included) a
``SpinNIC.step`` spends applying the handlers' effects
(``spin_nic.host_dma``, ``.egress``, ``.counters``, ``.free``), over the
profiled steps."""
from bench import program_trace


def read(r):
    return program_trace.ms_per(
        r, ("spin_nic.host_dma", "spin_nic.egress", "spin_nic.counters",
            "spin_nic.free"), "spin_nic.step")
