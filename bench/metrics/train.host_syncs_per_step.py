"""Times the host waited for the device (``host_syncs``) per
``trainer.step``, over the profiled steps: the overlap loop's waits and
any other sync on the path."""
from bench import program_trace


def read(r):
    return program_trace.counter_per(r, "host_syncs", "trainer.step")
