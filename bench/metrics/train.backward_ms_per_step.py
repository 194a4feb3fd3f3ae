"""Profiled host milliseconds (the profiler's cost included) of the Trainer
step's backward (``trainer.backward``: ``torch.autograd.grad``, remat's
recompute included) per ``trainer.step``, over the profiled steps."""
from bench import program_trace


def read(r):
    return program_trace.ms_per(r, ("trainer.backward",), "trainer.step")
