"""Public wrapper of the batched checksum kernel (K3).

``internet_checksum`` dispatches on the device of ``data``: a CPU tensor
takes the plain version in ``ref.py``; a CUDA tensor launches
``checksum.cu`` on the current stream (built at first use) or raises.
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checksum import ref as _ref

launches = 0


def _lib():
    fn = build.load("checksum").repro_checksum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
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
    if lengths.shape != data.shape[:1] or lengths.dtype != torch.int32:
        raise ValueError("internet_checksum: lengths must be (N,) int32")
    if start < 0:
        raise ValueError("internet_checksum: start must be >= 0")
    if data.device != lengths.device:
        raise ValueError("internet_checksum: data and lengths on different "
                         "devices")
    if data.device.type == "cpu":
        return _ref.checksum_ref(data, lengths, start)
    if data.device.type != "cuda":
        raise ValueError(f"internet_checksum: unsupported device "
                         f"{data.device}")
    if not (data.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("internet_checksum: data and lengths must be "
                         "contiguous")
    if data.shape[1] % 16 or data.data_ptr() % 16:
        raise ValueError("internet_checksum: rows must be 16-byte aligned")
    out = torch.empty(data.shape[:1], dtype=torch.int64, device=data.device)
    if data.shape[0] == 0:
        return out
    err = _lib()(data.data_ptr(), lengths.data_ptr(), data.shape[0],
                 data.shape[1], start, out.data_ptr(),
                 torch.cuda.current_stream(data.device).cuda_stream)
    if err:
        raise RuntimeError(f"internet_checksum: CUDA launch failed (error "
                           f"{err})")
    launches += 1
    return out
