"""Public wrappers of the DDT gather kernel (K2): gather, pack, unpack.

``pack``   : serialize a non-contiguous source buffer into a message
             (out[i] = buf[pack_idx[i]]).
``unpack`` : scatter a packed message into a destination buffer
             (dst[j]  = msg[unpack_idx[j]] where unpack_idx[j] >= 0,
              else keep dst[j]).

Both go through ``gather``, which dispatches on the device of ``src``: a
CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
``ddt_gather.cu`` on the current stream (built at first use) or raises.
The index maps come from :mod:`repro_torch.core.ddt`.  ``launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ddt import ref as _ref

launches = 0


@functools.cache
def _lib():
    """``repro_ddt_gather``, resolved and typed once."""
    fn = build.load("ddt").repro_ddt_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_uint64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def fill_bits(fill, dtype: torch.dtype) -> int:
    """The bit pattern of ``fill`` in ``dtype``, as an unsigned int."""
    if fill == 0 and math.copysign(1.0, fill) > 0:
        return 0                                   # the common case
    esize = torch.empty((), dtype=dtype).element_size()
    bits = torch.tensor([fill], dtype=dtype).view(_BITS[esize]).item()
    return int(bits) & ((1 << (8 * esize)) - 1)


def gather(src: torch.Tensor, idx: torch.Tensor, *, fill=0) -> torch.Tensor:
    """out[i] = src[idx[i]] (idx < 0 -> fill, idx >= S -> src[S-1]).
    1-D ``src`` of any dtype, 1-D int32 ``idx``; returns (I,) of src's
    dtype."""
    global launches
    if src.dim() != 1 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError("gather: src must be 1-D and idx 1-D int32")
    if src.shape[0] == 0:
        raise ValueError("gather: empty source")
    dev = src.device
    if idx.device != dev:
        raise ValueError("gather: src and idx on different devices")
    if dev.type == "cpu":
        return _ref.ddt_gather_ref(src, idx, fill)
    if dev.type != "cuda":
        raise ValueError(f"gather: unsupported device {dev}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather: src and idx must be contiguous")
    esize = src.element_size()
    if esize not in _BITS:
        raise ValueError(f"gather: element size {esize} not supported")
    out = torch.empty(idx.shape, dtype=src.dtype, device=dev)
    if idx.shape[0] == 0:
        return out
    err = _lib()(src.data_ptr(), src.shape[0], idx.data_ptr(), idx.shape[0],
                 out.data_ptr(), esize, fill_bits(fill, src.dtype),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gather: CUDA launch failed (error {err})")
    launches += 1
    return out


def pack(buf: torch.Tensor, pack_idx: torch.Tensor) -> torch.Tensor:
    """Serialize: message[i] = buf[pack_idx[i]]."""
    return gather(buf, pack_idx, fill=0)


def unpack(msg: torch.Tensor, unpack_idx: torch.Tensor, dst: torch.Tensor
           ) -> torch.Tensor:
    """De-serialize into a copy of dst: positions with unpack_idx >= 0
    receive msg[unpack_idx]; others keep their existing value (datatype
    holes)."""
    return torch.where(unpack_idx >= 0, gather(msg, unpack_idx, fill=0), dst)
