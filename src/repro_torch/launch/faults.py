"""Fault-tolerant execution wrapper; a copy of ``repro.launch.faults``
(standard library only).

``run_with_restarts`` is the supervisor a deployment runs per job: any
exception (preemption, device loss, the NaN guard) triggers a bounded
restart, and state comes back from the last atomic checkpoint
(``train/checkpoint.py``; ``Trainer.fit`` resumes from ``LATEST``).  The
per-step straggler watchdog lives in ``train/trainer.py``.  For the
elastic rescale of the JAX package (a restart on another device count),
``checkpoint.restore(..., shardings=)`` places a checkpoint's leaves on
the new mesh.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Any, Callable


@dataclasses.dataclass
class RestartReport:
    restarts: int
    succeeded: bool
    errors: list


def run_with_restarts(make_state: Callable[[], Any],
                      run: Callable[[Any, int], Any],
                      max_restarts: int = 3,
                      backoff_s: float = 0.0) -> tuple:
    """Supervisor loop.

    make_state(): build fresh (or checkpoint-restored) state; called before
    every attempt so a restart reloads from the last checkpoint.
    run(state, attempt): runs the job; raising triggers a restart.
    """
    errors = []
    for attempt in range(max_restarts + 1):
        state = make_state()
        try:
            result = run(state, attempt)
            return result, RestartReport(attempt, True, errors)
        except Exception as e:                    # noqa: BLE001
            errors.append(
                "".join(traceback.format_exception_only(type(e), e)).strip())
            if backoff_s:
                time.sleep(backoff_s * (2 ** attempt))
    return None, RestartReport(max_restarts, False, errors)


class NaNGuard:
    """Raises on non-finite loss — turns silent divergence into a restart
    (the checkpoint predates the blow-up)."""

    def __init__(self, patience: int = 1):
        self.patience = patience
        self.strikes = 0

    def check(self, loss: float):
        import math
        if not math.isfinite(loss):
            self.strikes += 1
            if self.strikes >= self.patience:
                raise FloatingPointError(f"non-finite loss {loss}")
        else:
            self.strikes = 0
