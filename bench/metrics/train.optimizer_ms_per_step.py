"""Profiled host milliseconds (the profiler's cost included) of the Trainer
step's AdamW (``trainer.optimizer``: clip and update) per
``trainer.step``, over the profiled steps."""
from bench import program_trace


def read(r):
    return program_trace.ms_per(r, ("trainer.optimizer",), "trainer.step")
