"""Public wrapper of mamba2's SSD decode mixer (K5).

``ssm_decode_mixer`` dispatches on the device of ``proj``: a CPU tensor
takes the plain version in ``ref.py``; a CUDA tensor launches
``ssm_decode.cu`` on the current stream (built at first use), two
kernels, or raises.  Fake tensors (``FakeTensorMode``, the dry run) take
the plain version too: they carry shapes and no data.  Both caches are
updated in place.  ``launches`` counts the kernel launches.
``ssm_decode_mixer_planted`` runs a variant built with a planted fault,
for the checks that must fail on it.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import build
from repro_torch.kernels.ssm_decode import ref as _ref

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256            # ssm_decode.cu's state_kernel block
MAX_WIDTH = 8            # conv taps the kernel takes
MAX_INNER = 8 * 1024     # d_inner its norm_kernel takes (NORM_ITEMS x 1,024)
SMEM_LIMIT = 48 * 1024   # static launch, no opt-in


@functools.cache
def _fn(planted: bool):
    """The library function (or its planted-fault variant's), resolved and
    typed once."""
    lib = build.load("ssm_decode_faults" if planted else "ssm_decode")
    fn = (lib.repro_ssm_decode_mixer_planted if planted
          else lib.repro_ssm_decode_mixer)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * 10 + [i] * 6 + [ctypes.c_float]
                   + ([i] if planted else []) + [p])
    fn.restype = ctypes.c_int
    return fn


def _check(proj, conv_cache, ssd_cache, conv_w, conv_b, dt_bias, a_log,
           d_skip, norm):
    """Shapes, dtypes, devices and contiguity; returns (B, H, N, P, K).
    Each is compared for all the tensors at once, written out (the decode
    step calls this once a layer: loops over the tensors cost it twice the
    host time); ``_diagnose`` names what is wrong."""
    if proj.dim() != 2 or ssd_cache.dim() != 4 or conv_w.dim() != 2:
        raise ValueError("ssm_decode_mixer: proj must be (B, W), ssd_cache "
                         "(B, H, N, P) and conv_w (K, C)")
    b, w = proj.shape
    _, nh, ns, hd = ssd_cache.shape
    k, ch = conv_w.shape
    dt, f32, dev = proj.dtype, torch.float32, proj.device
    if ((conv_cache.shape, ssd_cache.shape, conv_b.shape, dt_bias.shape,
         a_log.shape, d_skip.shape, norm.shape)
            != ((b, k - 1, ch), (b, nh, ns, hd), (ch,), (nh,), (nh,), (nh,),
                (nh * hd,))
            or ch != nh * hd + 2 * ns or w != nh * hd + ch + nh or k < 2
            or (conv_cache.dtype, ssd_cache.dtype, conv_b.dtype,
                dt_bias.dtype, a_log.dtype, d_skip.dtype, norm.dtype,
                conv_w.dtype) != (dt, f32, dt, f32, f32, f32, dt, dt)
            or (conv_cache.device, ssd_cache.device, conv_b.device,
                dt_bias.device, a_log.device, d_skip.device, norm.device,
                conv_w.device) != (dev, dev, dev, dev, dev, dev, dev, dev)
            or not (proj.is_contiguous() and conv_cache.is_contiguous()
                    and ssd_cache.is_contiguous() and conv_w.is_contiguous()
                    and conv_b.is_contiguous() and dt_bias.is_contiguous()
                    and a_log.is_contiguous() and d_skip.is_contiguous()
                    and norm.is_contiguous())):
        _diagnose((conv_cache, ssd_cache, conv_b, dt_bias, a_log, d_skip,
                   norm, conv_w, proj), b, w, nh, ns, hd, k, ch)
    return b, nh, ns, hd, k


def _diagnose(ts, b, w, nh, ns, hd, k, ch):
    """Raise naming the first thing ``_check`` found wrong."""
    names = ("conv_cache", "ssd_cache", "conv_b", "dt_bias", "a_log",
             "d_skip", "norm", "conv_w", "proj")
    want = ((b, k - 1, ch), (b, nh, ns, hd), (ch,), (nh,), (nh,), (nh,),
            (nh * hd,))
    for name, t, shape in zip(names, ts, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_decode_mixer: {name} is "
                             f"{tuple(t.shape)}, not {shape}")
    if ch != nh * hd + 2 * ns or w != nh * hd + ch + nh or k < 2:
        raise ValueError(f"ssm_decode_mixer: proj width {w} and conv "
                         f"channels {ch} do not fit H {nh}, N {ns}, P {hd} "
                         f"(need C = H P + 2 N, W = H P + C + H, K >= 2)")
    proj = ts[-1]
    for name, t in zip(names, ts):
        want_dt = (torch.float32 if name in ("ssd_cache", "dt_bias", "a_log",
                                             "d_skip") else proj.dtype)
        if t.dtype != want_dt:
            raise ValueError(f"ssm_decode_mixer: {name} is {t.dtype}, not "
                             f"{want_dt}")
        if t.device != proj.device:
            raise ValueError(f"ssm_decode_mixer: {name} on {t.device}, proj "
                             f"on {proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_decode_mixer: {name} must be contiguous")


def _check_cuda(dtype, nh, ns, hd, k, ssd_cache):
    """What the kernels take beyond ``_check``; raises naming the shape."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"ssm_decode_mixer: dtype {dtype} (the kernel "
                         f"takes float32 and bfloat16)")
    if k > MAX_WIDTH:
        raise ValueError(f"ssm_decode_mixer: conv width {k} (at most "
                         f"{MAX_WIDTH})")
    if nh < 1 or ns < 1:
        raise ValueError(f"ssm_decode_mixer: {nh} heads, state {ns} (the "
                         f"kernel takes at least 1 of each)")
    if hd < 4 or hd % 4 or hd // 4 > THREADS or THREADS % (hd // 4):
        raise ValueError(f"ssm_decode_mixer: head dim {hd} (a power of two "
                         f"from 4 to {4 * THREADS})")
    if nh * hd > MAX_INNER:
        raise ValueError(f"ssm_decode_mixer: d_inner {nh * hd} (at most "
                         f"{MAX_INNER})")
    if 4 * (hd + 2 * ns + 4 * THREADS) > SMEM_LIMIT:
        raise ValueError(f"ssm_decode_mixer: state {ns} and head dim {hd} "
                         f"need more than {SMEM_LIMIT} B of shared memory")
    if ssd_cache.data_ptr() % 16:
        raise ValueError("ssm_decode_mixer: ssd_cache must be 16-byte "
                         "aligned")


def ssm_decode_mixer(proj, conv_cache, ssd_cache, conv_w, conv_b, dt_bias,
                     a_log, d_skip, norm, eps: float) -> torch.Tensor:
    """One decode step of the mixer between mamba2's two projections.

    proj (B, W) = [z (di), xBC (C), dt (H)] in the model's dtype T;
    conv_cache (B, K-1, C) T and ssd_cache (B, H, N, P) float32, both
    updated in place; conv_w (K, C), conv_b (C,), norm (di,) T; dt_bias,
    a_log, d_skip (H,) float32.  Returns the gated norm's output (B, di)
    T."""
    args = (proj, conv_cache, ssd_cache, conv_w, conv_b, dt_bias, a_log,
            d_skip, norm)
    dims = _check(*args)
    if proj.is_cuda and not isinstance(proj, FakeTensor):
        return _launch(args, dims, eps, None)
    if proj.device.type == "cpu" or isinstance(proj, FakeTensor):
        return _ref.ssm_decode_mixer_ref(*args, eps)
    raise ValueError(f"ssm_decode_mixer: unsupported device {proj.device}")


def ssm_decode_mixer_planted(proj, conv_cache, ssd_cache, conv_w, conv_b,
                             dt_bias, a_log, d_skip, norm, eps: float, *,
                             fault: int) -> torch.Tensor:
    """``ssm_decode_mixer`` through the variant built with
    ``REPRO_K5_PLANTED_FAULTS`` (CUDA only): ``fault`` 1 leaves each
    head's last state row unchanged, 2 the B/C channels' conv window
    unshifted, 3 leaves out y's D x skip."""
    args = (proj, conv_cache, ssd_cache, conv_w, conv_b, dt_bias, a_log,
            d_skip, norm)
    dims = _check(*args)
    if proj.device.type != "cuda":
        raise ValueError("ssm_decode_mixer_planted: CUDA tensors only")
    return _launch(args, dims, eps, fault)


def _launch(args, dims, eps: float, fault):
    """The two kernels on CUDA tensors; ``fault`` None for the shipped
    library."""
    global launches
    proj, conv_cache, ssd_cache = args[:3]
    b, nh, ns, hd, k = dims
    _check_cuda(proj.dtype, nh, ns, hd, k, ssd_cache)
    # y before the norm is written here too, and normalised in place
    out = torch.empty((b, nh * hd), dtype=proj.dtype, device=proj.device)
    if b == 0:
        return out
    extra = () if fault is None else (fault,)
    # the current stream's handle without a torch.cuda.Stream object (one
    # costs about 10 us of host time, a sixth of this call's)
    stream = torch._C._cuda_getCurrentRawStream(proj.device.index)
    err = _fn(fault is not None)(
        *(t.data_ptr() for t in args), out.data_ptr(), b, nh, hd, ns, k,
        _DTYPE_CODE[proj.dtype], eps, *extra, stream)
    if err:
        raise RuntimeError(f"ssm_decode_mixer: CUDA launch failed (error "
                           f"{err})")
    launches += 2
    return out
