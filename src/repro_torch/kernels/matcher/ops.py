"""Public wrappers of the matching-engine kernel (K1).

``match_first`` is the whole matching stage (``core.matching.match_batch``):
per frame, the first matching context and its EOM bit.  ``match`` is the
(N, C) form the TPU kernel computes.  Each dispatches on the device of
``data``: a CPU tensor takes the plain version in ``ref.py``; a CUDA tensor
launches ``matcher.cu`` on the current stream (built at first use) or
raises.  ``launches`` counts the kernel launches of both forms, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matcher import ref as _ref

launches = 0
MAX_CONTEXTS = 512          # keeps the staged rule table under 48 KB

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "repro_match": [_P, _I64, _I64, _P, _P, _INT, _P, _P, _P],
    "repro_match_first": [_P, _I64, _I64, _P, _P, _INT, _P, _P, _P, _P],
}


@functools.cache
def _fn(name):
    """The library function ``name``, resolved and typed once."""
    fn = getattr(build.load("matcher"), name)
    fn.argtypes = _ARGTYPES[name]
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
    dev = data.device
    if rules.device != dev or modes.device != dev:
        raise ValueError("match: data, rules and modes on different devices")
    return dev


def _check_cuda(data, rules, modes, dev):
    if dev.type != "cuda":
        raise ValueError(f"match: unsupported device {dev}")
    if not (data.is_contiguous() and rules.is_contiguous()
            and modes.is_contiguous()) or data.data_ptr() % 4:
        raise ValueError("match: inputs must be contiguous and data "
                         "4-byte aligned")
    c = rules.shape[0]
    if not 1 <= c <= MAX_CONTEXTS:
        raise ValueError(f"match: 1..{MAX_CONTEXTS} contexts, got {c}")


def match(data: torch.Tensor, rules: torch.Tensor, modes: torch.Tensor):
    """(matched, eom), each (N, C) bool, for frames ``data`` (N, B) uint8.
    See ``ref.match_ref`` for the semantics."""
    global launches
    dev = _check(data, rules, modes)
    if dev.type == "cpu":
        return _ref.match_ref(data, rules, modes)
    _check_cuda(data, rules, modes, dev)
    n, c = data.shape[0], rules.shape[0]
    matched = torch.empty((n, c), dtype=torch.bool, device=dev)
    eom = torch.empty((n, c), dtype=torch.bool, device=dev)
    if n == 0:
        return matched, eom
    err = _fn("repro_match")(
        data.data_ptr(), n, data.shape[1], rules.data_ptr(), modes.data_ptr(),
        c, matched.data_ptr(), eom.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"match: CUDA launch failed (cudaError {err})")
    launches += 1
    return matched, eom


def match_first(data: torch.Tensor, rules: torch.Tensor, modes: torch.Tensor,
                valid: torch.Tensor):
    """(ctx_id, eom) for frames ``data`` (N, B) uint8 and lanes ``valid``
    (N,) bool: ctx_id (N,) int32, the lowest-numbered matching context or
    -1; eom (N,) bool, the winner's EOM rule.  See ``ref.match_first_ref``.
    One launch on CUDA."""
    global launches
    dev = _check(data, rules, modes)
    n = data.shape[0]
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,) \
            or valid.device != dev:
        raise ValueError("match_first: valid must be (N,) bool beside data")
    if dev.type == "cpu":
        return _ref.match_first_ref(data, rules, modes, valid)
    _check_cuda(data, rules, modes, dev)
    if not valid.is_contiguous():
        raise ValueError("match_first: valid must be contiguous")
    ctx_id = torch.empty((n,), dtype=torch.int32, device=dev)
    eom = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return ctx_id, eom
    err = _fn("repro_match_first")(
        data.data_ptr(), n, data.shape[1], rules.data_ptr(), modes.data_ptr(),
        rules.shape[0], valid.data_ptr(), ctx_id.data_ptr(), eom.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"match_first: CUDA launch failed (cudaError "
                           f"{err})")
    launches += 1
    return ctx_id, eom
