"""Public wrapper of the batched checksum kernel (K3).

``internet_checksum`` dispatches on the device of ``data``: a CPU tensor
takes the plain version in ``ref.py``; a CUDA tensor launches
``checksum.cu`` on the current stream (built at first use) or raises.
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checksum import ref as _ref

launches = 0


@functools.cache
def _fn():
    """The library function, resolved and typed once."""
    fn = build.load("checksum").repro_checksum
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    return fn


def internet_checksum(data: torch.Tensor, lengths: torch.Tensor, *,
                      start: int) -> torch.Tensor:
    """RFC1071 checksum over bytes [start, length) of each packet.

    data (N, W) uint8, lengths (N,) int32; returns (N,) int64 holding the
    16-bit value."""
    global launches
    if data.dim() != 2 or data.dtype != torch.uint8 or data.shape[1] % 2:
        raise ValueError("internet_checksum: data must be (N, W) uint8, W "
                         "even")
    n, w = data.shape
    if lengths.shape != (n,) or lengths.dtype != torch.int32:
        raise ValueError("internet_checksum: lengths must be (N,) int32")
    if start < 0:
        raise ValueError("internet_checksum: start must be >= 0")
    dev = data.device
    if lengths.device != dev:
        raise ValueError("internet_checksum: data and lengths on different "
                         "devices")
    if dev.type == "cpu":
        return _ref.checksum_ref(data, lengths, start)
    if dev.type != "cuda":
        raise ValueError(f"internet_checksum: unsupported device {dev}")
    if not (data.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("internet_checksum: data and lengths must be "
                         "contiguous")
    ptr = data.data_ptr()
    if w % 16 or ptr % 16:
        raise ValueError("internet_checksum: rows must be 16-byte aligned")
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    err = _fn()(ptr, lengths.data_ptr(), n, w, start, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"internet_checksum: CUDA launch failed (error "
                           f"{err})")
    launches += 1
    return out
