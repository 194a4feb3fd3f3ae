"""Profiled host milliseconds (the profiler's cost included) a
``SpinNIC.step`` spends running the header, packet and tail handlers
(``spin_nic.handlers``), over the profiled steps."""
from bench import program_trace


def read(r):
    return program_trace.ms_per(r, ("spin_nic.handlers",), "spin_nic.step")
