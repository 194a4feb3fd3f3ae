"""Public wrappers of the flash-attention kernels: the forward (K4) and its
backward (K4b), in the model's layout, with GQA, causal and sliding-window
masks.

``flash_attention`` dispatches on the device of ``q``: a CPU tensor takes
the plain version in ``ref.py``; a CUDA tensor launches
``flash_attention.cu`` on the current stream (built at first use) or
raises.  The kernel reads q/k/v through their strides, so the caller's
(B, S, heads, D) tensors are used as they are and K/V are never repeated
across a GQA group; in bfloat16 it reads them through TMA tensor maps,
which the launcher builds from the same pointers and strides at each
call.  When autograd needs its gradient, the call goes through a
``torch.autograd.Function`` whose forward asks K4 for each row's
log-sum-exp too and saves q, k, v, the output and lse; its backward is
``flash_attention_bwd``, which launches ``flash_attention_bwd.cu`` on
CUDA tensors (dQ with Delta, then dK and dV, from the saved lse) and
takes ``ref.flash_attention_bwd_ref`` on CPU tensors.  Without autograd
no lse is written (``flash_attention_with_lse`` asks for it).
``launches`` counts K4's launches and ``bwd_launches`` K4b's (one per
backward call).  ``flash_attention_bwd_planted`` runs a variant of K4b
built with a planted fault, for the checks that must fail on it.

``kv_len`` (int32 or int64 (B,), each value in [1, Sk]) is the per-batch
key length of whisper's cross-attention (``blockwise_attention``'s
``kv_len`` in the JAX package): key j of batch row b is live only if
j < kv_len[b].  K4 and K4b both take it as a device pointer, on top of
the causal and window masks; K4b's dK and dV rows of the keys past a
row's length are exactly 0, as the plain backward's are.

On the mesh path q, k and v are ``DTensor``s, split by batch over the
data axes and by heads over ``model``.  ``flash_attention`` then runs K4
(and K4b through autograd) on each rank's local shards and places the
output like q; no input is gathered.  Where ``model`` splits q's heads
but not k's (KV heads that do not divide the axis: k and v are whole on
every rank), each rank attends with the KV heads of its own query heads,
global query head h with KV head h // (H / KV), and its dk and dv are
partial sums over the axis.  ``_forward`` and ``_backward`` only ever see
local tensors: a DTensor there raises.

Off the CPU, each launch goes through a ``torch.library`` custom op,
``repro::flash_attention`` (K4) and ``repro::flash_attention_bwd`` (K4b),
so that a ``TorchDispatchMode`` sees it: each op has a fake
implementation (shapes only), so fake tensors (``FakeTensorMode``, on any
device) take the op and load no library, and a FLOP formula in
``torch.utils.flop_counter``'s registry: 4 D FLOPs per live (query, key)
pair and query head forward, 10 D backward (the two products of the
forward; the recomputed scores, dP, dV, dQ and dK), with the live pairs
counted in closed form by the kernel's own rule (``live_pairs``).  A
``kv_len``'s values come from the read ``_check_kv_len`` already makes
(kept on the tensor); a fake ``kv_len`` has none and counts as Sk.  Real
CPU tensors take the plain version directly, as before.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.parallel import dtensor as dt

launches = 0
bwd_launches = 0

HEAD_DIMS = (64, 128, 256)            # head_dim the CUDA kernel is built for
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib():
    fn = build.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6
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


def _check_args(q, k, v) -> None:
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


def _check_kv_len(q, k, kv_len):
    """``kv_len`` as int32 (B,) on q's device, contiguous, or None; raises
    ``ValueError`` for another shape, device or dtype, or a value outside
    [1, Sk] (no caller sends one: the shapes draw ``enc_len`` = Sk).  The
    range is read from the device once per tensor and version (a host
    synchronisation): a prefill's cross-attention layers share one
    ``enc_len``, so it reads it once."""
    if kv_len is None:
        return None
    if kv_len.shape != (q.shape[0],) or kv_len.device != q.device or \
            kv_len.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"flash_attention: kv_len must be int32 or int64 "
                         f"(B,) = ({q.shape[0]},) on q's device")
    if isinstance(kv_len, FakeTensor):          # no values to read
        return kv_len.to(torch.int32).contiguous()
    # (its version, its values) is kept on the tensor; an inference tensor
    # keeps no version, so its values are read every call
    version = None if kv_len.is_inference() else kv_len._version
    seen = getattr(kv_len, "_repro_kv_len", None)
    if version is None or seen is None or seen[0] != version:
        values = tuple(kv_len.tolist())
        if min(values) < 1:
            raise ValueError(f"flash_attention: kv_len must be at least 1, "
                             f"got {min(values)}")
        seen = (version, values)
        if version is not None:
            kv_len._repro_kv_len = seen
    if max(seen[1]) > k.shape[1]:
        raise ValueError(f"flash_attention: kv_len must lie in [1, Sk] = "
                         f"[1, {k.shape[1]}], got {max(seen[1])}")
    out = kv_len.to(torch.int32).contiguous()
    if out is not kv_len:                # its own version, the same values
        seen = (None if out.is_inference() else out._version, seen[1])
    out._repro_kv_len = seen             # for the FLOP formulas too
    return out


def live_pairs(sq: int, sk: int, causal: bool, window: int,
               kv_len: int = None) -> int:
    """The (query, key) pairs K4 computes for one batch row and head: key j
    of query i is live when j <= i (``causal``), j > i - window (``window``
    > 0) and j < ``kv_len`` (None: Sk).  In closed form: the count of row
    i is linear in i between the kinks of its min and max terms, so each
    stretch between kinks is an arithmetic series."""
    m = sk if kv_len is None else min(kv_len, sk)

    def row(i: int) -> int:
        hi = min(i + 1, m) if causal else m
        lo = max(0, i - window + 1) if window > 0 else 0
        return max(0, hi - lo)

    kinks = {0, sq, m - 1, m}
    if window > 0:
        kinks |= {window - 1, window, m + window - 1, m + window}
    cuts = sorted(x for x in kinks if 0 <= x <= sq)
    return sum((b - a) * (row(a) + row(b - 1)) // 2
               for a, b in zip(cuts, cuts[1:]) if b > a)


def _pairs(q, k, causal: bool, window: int, kv_len) -> int:
    """Live pairs summed over the batch rows, for one head."""
    sq, sk = q.shape[1], k.shape[1]
    seen = None if kv_len is None else getattr(kv_len, "_repro_kv_len", None)
    if kv_len is not None and seen is None and \
            not isinstance(kv_len, FakeTensor):
        seen = (None, tuple(kv_len.tolist()))      # a caller of the op
    if seen is None:                               # none, or fake: Sk
        return q.shape[0] * live_pairs(sq, sk, causal, window)
    counts = {}
    for n in seen[1]:
        counts[n] = counts.get(n, 0) + 1
    return sum(c * live_pairs(sq, sk, causal, window, n)
               for n, c in counts.items())


def _check_cuda(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS} "
                         f"on CUDA")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"on CUDA (bfloat16, float32)")


def _local_only(*ts) -> None:
    """The launchers take local tensors: a DTensor's device and data
    pointer are its shard's, and it must never reach the plain version."""
    if any(dt.is_dt(t) for t in ts):
        raise TypeError("flash_attention: a DTensor reached the launcher; "
                        "call flash_attention, which runs on local shards")


class _FlashAttention(torch.autograd.Function):
    """K4 forward (with lse), K4b backward (from the saved lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        out, lse = _forward(q, k, v, causal, window, kv_len, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.kv_len = causal, window, kv_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, causal=ctx.causal,
                                         window=ctx.window, lse=lse,
                                         kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: torch.Tensor = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype.

    Query i and key j are at absolute positions i and j (from 0).  causal
    keeps j <= i; window > 0 keeps j > i - window; ``kv_len`` (B,) keeps
    j < kv_len[b].  Scale 1/sqrt(D).  Differentiable in q, k and v
    (backward: ``flash_attention_bwd``).  DTensor q, k, v run on their
    local shards (module docstring)."""
    if dt.is_dt(q):
        return _flash_attention_dtensor(q, k, v, causal, window, kv_len)
    _check_args(q, k, v)
    kv_len = _check_kv_len(q, k, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, kv_len)
    return _forward(q, k, v, causal, window, kv_len)


def _flash_attention_dtensor(q, k, v, causal: bool, window: int, kv_len):
    """``flash_attention`` of DTensor q, k, v on each rank's local shards;
    the output placed like q.  ``kv_len``: a DTensor split like q's
    batch."""
    from torch.distributed.tensor import DTensor
    q, k, v = dt.settle(q), dt.settle(k), dt.settle(v)
    if not (dt.is_dt(k) and dt.is_dt(v)) or k.placements != v.placements \
            or k.device_mesh != q.device_mesh:
        raise ValueError("flash_attention: DTensor q needs DTensor k and v "
                         "placed alike on q's mesh")
    _check_args(q, k, v)
    mesh, place = q.device_mesh, tuple(q.placements)
    for pq, pk in zip(place, k.placements):
        if pq.is_shard(0) != pk.is_shard(0) or pq.is_shard(1) or \
                pk.is_shard(1) or (pk.is_shard(2) and not pq.is_shard(2)):
            raise ValueError(f"flash_attention: q placed {place} and k "
                             f"placed {tuple(k.placements)} do not fit")
    (_, _, hl, _), qoff = dt.local_shape_and_offset(q.shape, mesh, place)
    (_, _, kvl, _), koff = dt.local_shape_and_offset(k.shape, mesh,
                                                     k.placements)
    group = q.shape[2] // k.shape[2]
    ql = q.to_local()
    kv_grad = dt.grad_placements(k, place) if (k.requires_grad
                                               or v.requires_grad) else None
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    # the KV heads of this rank's query heads, as local indices into kl:
    # where k is split like q they are kl's own heads; where k is whole,
    # one KV head per query head (GQA group 1)
    need = [(qoff[2] + i) // group - koff[2] for i in range(hl)]
    if need != [i // group for i in range(hl)] or hl // group != kvl:
        idx = torch.tensor(need, device=kl.device)
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    if kv_len is not None:
        kv_len = dt.settle(kv_len)
        if not dt.is_dt(kv_len) or [p.is_shard(0) for p in
                                    kv_len.placements] != \
                [p.is_shard(0) for p in place]:
            raise ValueError("flash_attention: kv_len must be a DTensor "
                             "split like q's batch")
        kv_len = kv_len.to_local()
    out = flash_attention(ql, kl, vl, causal=causal, window=window,
                          kv_len=kv_len).contiguous()   # a no-op for K4's
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, kv_len: torch.Tensor = None):
    """``flash_attention`` without autograd, and each row's log-sum-exp of
    the scaled, masked scores: (out (B, Sq, H, D), lse float32 (B, H, Sq),
    +inf for a row with no live key).  One K4 launch on CUDA tensors."""
    _check_args(q, k, v)
    return _forward(q, k, v, causal, window, _check_kv_len(q, k, kv_len),
                    with_lse=True)


def _forward(q, k, v, causal: bool, window: int, kv_len=None,
             with_lse: bool = False):
    """The output, or (output, lse) with ``with_lse``; ``kv_len`` as
    ``_check_kv_len`` returns it."""
    _local_only(q, k, v)
    if q.device.type == "cpu" and not isinstance(q, FakeTensor):
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, kv_len=kv_len,
                                        return_lse=with_lse)
    out, lse = torch.ops.repro.flash_attention(q, k, v, kv_len, causal,
                                               window, with_lse)
    return (out, lse) if with_lse else out


@torch.library.custom_op("repro::flash_attention", mutates_args=())
def _k4_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: Optional[torch.Tensor], causal: bool, window: int,
           with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's launch: (out, lse), lse empty (0,) without ``with_lse``."""
    out, lse = _launch(q, k, v, causal, window, kv_len, with_lse)
    return out, (lse if with_lse else
                 torch.empty(0, dtype=torch.float32, device=q.device))


@_k4_op.register_fake
def _(q, k, v, kv_len, causal, window, with_lse):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty(
        (b, h, sq) if with_lse else (0,), dtype=torch.float32)


@register_flop_formula(torch.ops.repro.flash_attention, get_raw=True)
def _k4_flops(q, k, v, kv_len, causal, window, with_lse, *args, **kwargs
              ) -> int:
    return 4 * q.shape[3] * q.shape[2] * _pairs(q, k, causal, window,
                                                kv_len)


def _launch(q, k, v, causal: bool, window: int, kv_len, with_lse: bool):
    """K4 on CUDA tensors: (out, lse or None)."""
    global launches
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    _check_cuda(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or sk == 0:
        out.zero_()
        return out, (lse.fill_(torch.inf) if with_lse else None)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 None if kv_len is None else kv_len.data_ptr(), b, sq, sk, h,
                 kvh,
                 d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 _DTYPE_CODE[q.dtype], int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA launch failed (error "
                           f"{err})")
    launches += 1
    return out, lse


_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 6 + [ctypes.c_int] * 3


def _bwd_fn(planted: bool):
    """K4b's launcher and workspace size (floats) from its library, or
    from the planted-fault variant's."""
    lib = build.load("flash_attention_bwd_faults" if planted
                     else "flash_attention_bwd")
    fn = (lib.repro_flash_attention_bwd_planted if planted
          else lib.repro_flash_attention_bwd)
    ws = lib.repro_flash_attention_bwd_workspace
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGS + ([ctypes.c_int, ctypes.c_int64] if planted
                                   else []) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int64] * 6 + [ctypes.c_int] * 3
        ws.restype = ctypes.c_int64
    return fn, ws


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        lse: torch.Tensor = None,
                        kv_len: torch.Tensor = None):
    """Gradients of ``flash_attention(q, k, v)`` at ``do``, given its output
    ``o`` and, where the caller has it, its row log-sum-exp ``lse``
    (float32 (B, H, Sq), as ``flash_attention_with_lse`` gives it): (dq
    (B, Sq, H, D), dk, dv (B, Sk, KV, D)) in the inputs' dtype.  K4b on
    CUDA tensors (without ``lse``, one K4 launch writes it first; K4b never
    recomputes it), ``ref.flash_attention_bwd_ref`` on CPU tensors.
    ``kv_len`` (B,), as ``flash_attention`` takes it, keeps key j of batch
    row b only if j < kv_len[b]: the dk and dv rows past it are 0."""
    _check_args(q, k, v)
    return _backward(q, k, v, o, do, causal, window, (), lse,
                     _check_kv_len(q, k, kv_len))


def flash_attention_bwd_planted(q, k, v, o, do, *, causal: bool = True,
                                window: int = 0, fault: int, tile: int = 1,
                                lse: torch.Tensor = None,
                                kv_len: torch.Tensor = None):
    """``flash_attention_bwd`` on CUDA tensors through the variant of K4b
    built with ``REPRO_K4B_PLANTED_FAULTS``: ``fault`` 1 leaves key tile
    ``tile`` (-1: the last) out of the dK/dV work, 2 leaves Delta out of
    dS, 3 reads each row's lse from the next row, 4 ignores ``kv_len`` in
    the dK/dV walk.  Not counted in ``bwd_launches``."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd_planted: CUDA tensors only")
    _check_args(q, k, v)
    return _backward(q, k, v, o, do, causal, window, (fault, tile), lse,
                     _check_kv_len(q, k, kv_len))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA's and the 16-byte
    loads' requirement), copied only where it is not."""
    t = t.contiguous()
    if isinstance(t, FakeTensor):                  # no address
        return t
    return t.clone() if t.data_ptr() % 16 else t


def _backward(q, k, v, o, do, causal: bool, window: int, planted: tuple,
              lse, kv_len):
    """K4b or the plain backward; ``kv_len`` as ``_check_kv_len`` returns
    it."""
    _local_only(q, k, v, o, do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and do must have q's shape")
    if not (o.device == do.device == q.device):
        raise ValueError("flash_attention_bwd: o, do not on q's device")
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if lse is not None and (lse.shape != (b, h, sq)
                            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be (B, H, Sq) = "
                         f"{(b, h, sq)} on q's device")
    if q.device.type == "cpu" and not isinstance(q, FakeTensor):
        return _ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                            window=window, lse=lse,
                                            kv_len=kv_len)
    if lse is None and q.numel() and k.numel():
        lse = _forward(*(_aligned(t.to(q.dtype)) for t in (q, k, v)),
                       causal, window, kv_len, with_lse=True)[1]
    if planted:
        return _bwd_launch(q, k, v, o, do, causal, window, planted, lse,
                           kv_len)
    return torch.ops.repro.flash_attention_bwd(q, k, v, o, do, lse, kv_len,
                                               causal, window)


@torch.library.custom_op("repro::flash_attention_bwd", mutates_args=())
def _k4b_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, do: torch.Tensor, lse: Optional[torch.Tensor],
            kv_len: Optional[torch.Tensor], causal: bool, window: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b's launch: (dq, dk, dv)."""
    return _bwd_launch(q, k, v, o, do, causal, window, (), lse, kv_len)


@_k4b_op.register_fake
def _(q, k, v, o, do, lse, kv_len, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro.flash_attention_bwd, get_raw=True)
def _k4b_flops(q, k, v, o, do, lse, kv_len, causal, window, *args,
               **kwargs) -> int:
    return 10 * q.shape[3] * q.shape[2] * _pairs(q, k, causal, window,
                                                 kv_len)


def _bwd_launch(q, k, v, o, do, causal: bool, window: int, planted: tuple,
                lse, kv_len):
    """K4b (or its planted-fault variant) on CUDA tensors."""
    global bwd_launches
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    _check_cuda(q, k, v)
    q, k, v, o, do = (_aligned(t.to(q.dtype)) for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = lse.to(torch.float32).contiguous()
    fn, ws = _bwd_fn(bool(planted))
    n_work = ws(b, sq, sk, h, kvh, d, _DTYPE_CODE[q.dtype], int(causal),
                int(window))
    if n_work < 0:
        raise RuntimeError("flash_attention_bwd: cannot query the device")
    work = torch.empty(n_work, dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(),
             None if kv_len is None else kv_len.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), work.data_ptr(), b, sq, sk, h, kvh,
             d,
             _DTYPE_CODE[q.dtype], int(causal), int(window), *planted,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: CUDA launch failed (error "
                           f"{err})")
    if not planted:
        bwd_launches += 1
    return dq, dk, dv
