"""Public wrapper of the flash-attention kernel (K4): forward attention in
the model's layout, with GQA, causal and sliding-window masks.

``flash_attention`` dispatches on the device of ``q``: a CPU tensor takes
the plain version in ``ref.py``; a CUDA tensor launches
``flash_attention.cu`` on the current stream (built at first use) or
raises.  The kernel reads q/k/v through their strides, so the caller's
(B, S, heads, D) tensors are used as they are and K/V are never repeated
across a GQA group; in bfloat16 it reads them through TMA tensor maps,
which the launcher builds from the same pointers and strides at each
call.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref as _ref

launches = 0

HEAD_DIMS = (64, 128, 256)            # head_dim the CUDA kernel is built for
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib():
    fn = build.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
                       + [ctypes.c_int64] * 9 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one bfloat16 block at head_dim ``d``."""
    fn = build.load("flash_attention").repro_flash_attention_smem
    fn.argtypes, fn.restype = [ctypes.c_int64], ctypes.c_int
    return fn(d)


def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         f"dimension")
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
        raise ValueError(f"flash_attention: bfloat16 {name} needs 16-byte "
                         f"aligned rows (strides a multiple of 8)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype.

    Query i and key j are at absolute positions i and j (from 0).  causal
    keeps j <= i; window > 0 keeps j > i - window.  Scale 1/sqrt(D)."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B,Sq,H,D), k = v (B,Sk,KV,D)")
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    if k.shape[0] != b or dk != d or h % kvh:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not fit")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v of different dtypes")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS} "
                         f"on CUDA")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"on CUDA (bfloat16, float32)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, kvh, d, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], _DTYPE_CODE[q.dtype], int(causal),
                 int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA launch failed (error "
                           f"{err})")
    launches += 1
    return out
