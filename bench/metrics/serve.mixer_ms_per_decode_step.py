"""Profiled host milliseconds (the profiler's cost included) of the SSD
mixers' decode (``ssm.decode``, one a layer) per ``serve.step``, over
the profiled decode steps."""
from bench import program_trace


def read(r):
    return program_trace.ms_per(r, ("ssm.decode",), "serve.step")
