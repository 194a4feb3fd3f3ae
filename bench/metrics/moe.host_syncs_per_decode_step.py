"""The program's ``host_syncs`` counter (places where the host waits for
the device) per ``serve.step``, over the profiled decode steps."""
from bench import program_trace


def read(r):
    return program_trace.counter_per(r, "host_syncs", "serve.step")
