"""PyTorch port of the FPsPIN model in ``repro``, for an NVIDIA H100.

The package mirrors ``repro``'s module paths (``repro.core.spin_nic`` ->
``repro_torch.core.spin_nic``) so that a test can feed the same numpy
inputs to both and compare the results.  It imports neither ``jax`` nor
``repro``.

Entry points take a ``device`` that defaults to ``"cuda"``; asking for
CUDA on a machine without a GPU raises instead of running on the CPU.
On CUDA tensors the hand-written kernels in ``repro_torch.kernels`` run
(built with ``nvcc`` at first launch); on CPU tensors their plain
PyTorch versions do.  Importing the package builds nothing.

Unsigned 32-bit fields (packet words, msg ids, MPQ keys, rule tables,
the expect table) are held as ``int64`` masked to 32 bits, because
``torch.uint32`` has no shift, compare or add on the CPU.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain versions")
    return dev


def card_line() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed ({e})"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else f"nvidia-smi failed ({r.returncode})"
