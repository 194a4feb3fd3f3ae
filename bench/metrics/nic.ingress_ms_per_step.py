"""Profiled host milliseconds (the profiler's cost included) a
``SpinNIC.step`` spends in its first four stages (``spin_nic.match``,
``.alloc``, ``.l2_dma``, ``.her``: K1, the allocator, the L2 copy,
HER/MPQ), over the profiled steps."""
from bench import program_trace


def read(r):
    return program_trace.ms_per(
        r, ("spin_nic.match", "spin_nic.alloc", "spin_nic.l2_dma",
            "spin_nic.her"), "spin_nic.step")
