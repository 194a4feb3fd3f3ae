"""Times the host waited for the device (``host_syncs``: the poll's
reads of the completion FIFO) per ``SpinNIC.step``, over the profiled
steps."""
from bench import program_trace


def read(r):
    return program_trace.counter_per(r, "host_syncs", "spin_nic.step")
