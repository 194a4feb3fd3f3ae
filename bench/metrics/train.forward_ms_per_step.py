"""Profiled host milliseconds (the profiler's cost included) of the Trainer
step's forward (``trainer.forward``: ``loss_fn``) per ``trainer.step``,
over the profiled steps."""
from bench import program_trace


def read(r):
    return program_trace.ms_per(r, ("trainer.forward",), "trainer.step")
