"""Public wrapper of the matching-engine kernel (K1).

``match`` dispatches on the device of ``data``: a CPU tensor takes the
plain version in ``ref.py``; a CUDA tensor launches ``matcher.cu`` on the
current stream (built at first use) or raises.  ``launches`` counts the
kernel launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matcher import ref as _ref

launches = 0
MAX_CONTEXTS = 512          # keeps the staged rule table under 48 KB


def _lib():
    fn = build.load("matcher").repro_match
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(data, rules, modes):
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[1] % 4:
        raise ValueError("match: data must be (N, 4k) uint8")
    c = rules.shape[0]
    if rules.dtype != torch.int64 or tuple(rules.shape) != (c, 4, 4):
        raise ValueError("match: rules must be (C, 4, 4) int64")
    if modes.dtype != torch.int32 or tuple(modes.shape) != (c,):
        raise ValueError("match: modes must be (C,) int32")
    if not (data.device == rules.device == modes.device):
        raise ValueError("match: data, rules and modes on different devices")


def match(data: torch.Tensor, rules: torch.Tensor, modes: torch.Tensor):
    """(matched, eom), each (N, C) bool, for frames ``data`` (N, B) uint8.
    See ``ref.match_ref`` for the semantics."""
    global launches
    _check(data, rules, modes)
    if data.device.type == "cpu":
        return _ref.match_ref(data, rules, modes)
    if data.device.type != "cuda":
        raise ValueError(f"match: unsupported device {data.device}")
    n, c = data.shape[0], rules.shape[0]
    if not (data.is_contiguous() and rules.is_contiguous()
            and modes.is_contiguous()) or data.data_ptr() % 4:
        raise ValueError("match: inputs must be contiguous and data "
                         "4-byte aligned")
    if not 1 <= c <= MAX_CONTEXTS:
        raise ValueError(f"match: 1..{MAX_CONTEXTS} contexts, got {c}")
    matched = torch.empty((n, c), dtype=torch.bool, device=data.device)
    eom = torch.empty((n, c), dtype=torch.bool, device=data.device)
    if n == 0:
        return matched, eom
    fn = _lib()
    err = fn(data.data_ptr(), n, data.shape[1], rules.data_ptr(),
             modes.data_ptr(), c, matched.data_ptr(), eom.data_ptr(),
             torch.cuda.current_stream(data.device).cuda_stream)
    if err:
        raise RuntimeError(f"match: CUDA launch failed (cudaError {err})")
    launches += 1
    return matched, eom
