"""Public wrapper of the grouped expert kernel (K6): the routed SwiGLU
experts of a dropless MoE layer over rows sorted by expert.

K6 replaces no TPU kernel (``moe_experts.cu`` says what the JAX package
does instead and how the kernel works): two ``sm_90a`` launches over the
sorted rows, ``k6_gate_up`` (both first-stage products, float32
accumulation, the SwiGLU in their epilogue) and ``k6_down``, each block
one tile of one expert found from the device offsets, the grid an upper
bound of the tiles, so nothing is read on the host and an expert with no
rows reads no weights.  Tile sizes follow the row count (``CONFIGS``).

``moe_experts`` dispatches on the device of ``x``: each call goes through
the custom op ``repro::moe_experts`` (so a profile names it, on the CPU
too), whose CPU implementation is the plain per-expert loop in
``ref.py`` and whose CUDA implementation launches the kernels (built by
``nvcc`` at first use, ``kernels/build.py``) or raises; fake tensors take
its fake implementation.  Autograd: on the CPU a call that needs a
gradient runs the plain loop directly, so autograd goes through it; on
CUDA it raises (K6 has no backward).  ``launches`` counts the kernel
launches (two a call).  ``active_experts(device)`` reads, once, the
device counter of (call, expert) pairs that had at least one row, which
the first kernel adds to; ``moe_experts_planted`` runs the variant built
with ``-DREPRO_K6_PLANTED_FAULTS``, for the checks that must fail on it.
"""
import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.moe_experts import ref as _ref

launches = 0
# substrings of the two kernels' names in a profile
KERNELS = ("k6_gate_up", "k6_down")
_active: Dict[torch.device, torch.Tensor] = {}
MAX_EXPERTS = 256        # moe_experts.cu's tile search
# moe_experts.cu's tile configurations (16-, 64- and 128-row tiles) by the
# largest row count each serves
CONFIGS = ((256, 0), (4096, 1), (None, 2))


def _config(rows: int) -> int:
    for most, cfg in CONFIGS:
        if most is None or rows <= most:
            return cfg


@functools.cache
def _fn(planted: bool):
    """The library function (or its planted-fault variant's), resolved and
    typed once."""
    lib = build.load("moe_experts_faults" if planted else "moe_experts")
    fn = (lib.repro_moe_experts_planted if planted
          else lib.repro_moe_experts)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * (6 if planted else 5) + [p]
    fn.restype = ctypes.c_int
    return fn


def active_counter(device) -> torch.Tensor:
    """The int32 (1,) device counter of active (call, expert) pairs."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    c = _active.get(device)
    if c is None:
        # a normal tensor even when made under inference mode, so that it
        # can be reset outside it
        with torch.inference_mode(False):
            c = _active[device] = torch.zeros(1, dtype=torch.int32,
                                              device=device)
    return c


def active_experts(device) -> int:
    """The counter's value (one host read)."""
    return int(active_counter(device).item())


def reset_active(device) -> None:
    active_counter(device).zero_()


def _check(x, offsets, gate, up, down) -> Tuple[int, int, int, int]:
    """Shapes, dtypes, devices; returns (R, d, ff, E)."""
    if x.dim() != 2 or offsets.dim() != 1 or gate.dim() != 3:
        raise ValueError("moe_experts: x must be (R, d), offsets (E + 1,) "
                         "and gate (E_pad, d, ff)")
    r, d = x.shape
    e = offsets.numel() - 1
    e_pad, _, ff = gate.shape
    if (tuple(up.shape) != (e_pad, d, ff)
            or tuple(down.shape) != (e_pad, ff, d) or not 1 <= e <= e_pad):
        raise ValueError(f"moe_experts: gate {tuple(gate.shape)}, up "
                         f"{tuple(up.shape)}, down {tuple(down.shape)} and "
                         f"{e + 1} offsets do not fit rows of width {d}")
    if not (gate.dtype == up.dtype == down.dtype == x.dtype):
        raise ValueError(f"moe_experts: x {x.dtype}, weights {gate.dtype}, "
                         f"{up.dtype}, {down.dtype}")
    if offsets.dtype != torch.int64:
        raise ValueError(f"moe_experts: offsets {offsets.dtype} (int64)")
    if len({t.device for t in (x, offsets, gate, up, down)}) != 1:
        raise ValueError("moe_experts: tensors on different devices")
    return r, d, ff, e


def moe_experts(x: torch.Tensor, offsets: torch.Tensor, gate: torch.Tensor,
                up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The routed experts over sorted rows: x (R, d) with expert e's rows
    at ``offsets[e]:offsets[e + 1]`` (offsets (E + 1,) int64 on x's device,
    offsets[E] = R); gate, up (E_pad, d, ff) and down (E_pad, ff, d),
    E <= E_pad.  Returns (R, d) in x's dtype."""
    _check(x, offsets, gate, up, down)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gate, up, down)):
        if x.device.type != "cpu":
            raise NotImplementedError(
                "moe_experts: K6 has no backward; training a dropless MoE "
                "runs on the CPU only (the plain loop)")
        return _ref.moe_experts_ref(x, offsets, gate, up, down)
    # a fake call (the dry run) counts into a fake counter of its own
    active = (torch.zeros(1, dtype=torch.int32, device=x.device)
              if isinstance(x, FakeTensor) else active_counter(x.device))
    return torch.ops.repro.moe_experts(x, offsets, gate, up, down, active)


@torch.library.custom_op("repro::moe_experts", mutates_args=("active",))
def _k6_op(x: torch.Tensor, offsets: torch.Tensor, gate: torch.Tensor,
           up: torch.Tensor, down: torch.Tensor,
           active: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        active += (offsets[1:] > offsets[:-1]).sum().to(active.dtype)
        return _ref.moe_experts_ref(x, offsets, gate, up, down)
    if x.device.type == "cuda":
        return _launch(x, offsets, gate, up, down, active, 0)
    raise ValueError(f"moe_experts: unsupported device {x.device}")


@_k6_op.register_fake
def _(x, offsets, gate, up, down, active):
    return x.new_empty(x.shape)


@register_flop_formula(torch.ops.repro.moe_experts, get_raw=True)
def _k6_flops(x, offsets, gate, up, down, active, *args, **kwargs) -> int:
    return 6 * x.shape[0] * x.shape[1] * gate.shape[2]


def moe_experts_planted(x, offsets, gate, up, down, *, fault: int
                        ) -> torch.Tensor:
    """``moe_experts`` through the variant built with
    ``REPRO_K6_PLANTED_FAULTS`` (CUDA only; not counted in ``launches``):
    ``fault`` 1 leaves the last depth tile out of the first stage's
    products, 2 reads each tile's weights from the next expert's, 3 takes
    the SiLU of the up product in place of the gate's."""
    _check(x, offsets, gate, up, down)
    if x.device.type != "cuda":
        raise ValueError("moe_experts_planted: CUDA tensors only")
    return _launch(x, offsets, gate, up, down,
                   torch.zeros(1, dtype=torch.int32, device=x.device),
                   fault)


def _launch(x, offsets, gate, up, down, active, fault: int,
            cfg: int = None) -> torch.Tensor:
    """Both kernels on CUDA tensors (``fault`` 0: the shipped library);
    ``cfg`` the tile configuration, by default ``_config``'s."""
    global launches
    r, d, ff, e = _check(x, offsets, gate, up, down)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"moe_experts: dtype {x.dtype} (K6 takes "
                         f"bfloat16)")
    if not all(t.is_contiguous() for t in (x, offsets, gate, up, down)):
        raise ValueError("moe_experts: every input must be contiguous")
    if d % 8 or ff % 8 or e > MAX_EXPERTS:
        raise ValueError(f"moe_experts: d {d} and ff {ff} must be multiples "
                         f"of 8, and at most {MAX_EXPERTS} experts ({e})")
    if any(t.data_ptr() % 16 for t in (x, gate, up, down)):
        raise ValueError("moe_experts: rows and weights must be 16-byte "
                         "aligned")
    y = torch.empty((r, d), dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    h = torch.empty((r, ff), dtype=x.dtype, device=x.device)
    extra = (fault,) if fault else ()
    # the current stream's handle without a torch.cuda.Stream object
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    err = _fn(bool(fault))(
        x.data_ptr(), offsets.data_ptr(), gate.data_ptr(), up.data_ptr(),
        down.data_ptr(), h.data_ptr(), y.data_ptr(), active.data_ptr(), r, d,
        ff, e, _config(r) if cfg is None else cfg, *extra, stream)
    if err:
        raise RuntimeError(f"moe_experts: CUDA launch failed (error {err})")
    if fault == 0:
        launches += 2
    return y
