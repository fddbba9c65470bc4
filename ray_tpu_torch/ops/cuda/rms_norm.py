"""RMSNorm as a pair of hand-written CUDA kernels for Hopper (sm_90a) and
the autograd Function that joins them: `rms_norm`.

It replaces no Pallas kernel (the JAX package leaves the norm to XLA's
fusion). `ray_tpu_torch/csrc/rms_norm.cu` says what bounds the kernels and
what their design does about it. Their plain version is `rms_norm_plain` in
`ray_tpu_torch/models/transformer.py`, the expression the decoder runs off
the card; `models/transformer.py:rms_norm` chooses between the two by the
input's device. The kernels keep the plain version's rounding points: f32
statistics, the normalised row and the weight each rounded to the input's
type before their product. For CUDA tensors `rms_norm` launches the kernels
or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.cuda._build import kernel_launches, load_library

SOURCE = "rms_norm.cu"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
CHUNK = 8  # elements of a 16-byte vector of a row: d must be a multiple
MAX_D = 8192  # 512 threads a row, two vectors each
# The kernels' y, dx and dw against f64 autograd of the same function with
# its rounding points taken as exact (n = x r, dn = dy T(w)), as a share of
# the magnitude of each output's terms (y's |x r T(w)|; dx's |r dn| +
# |x| r^3 sum|dn x| / d; dw's sum over rows |dy n|): the kernels round n,
# dn and the product to x's type (half an ulp each, 2^-9 of the value in
# bf16) and sum in f32 (each addition within 2^-24 of the running sum, some
# 100 deep at most: 2^-17); twice that. Plus one ulp of the output's type
# at the f64 value, for its rounding (`f64_reference`).
TERM_SHARE = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -16}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The library, each entry point's types declared once."""
    lib = load_library("rms_norm", [SOURCE])
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
        ("rms_norm_fwd", [ptr] * 4 + [ll, i, ctypes.c_float, i, i, i, ptr]),
        ("rms_norm_bwd_parts", [ll, i, i, i, i]),
        ("rms_norm_bwd", [ptr] * 6 + [ll, i, i, i, i, ptr]),
        ("rms_norm_dw", [ptr] * 2 + [i, i, i, ptr]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _bwd_parts(rows: int, d: int, x_code: int, w_code: int, sms: int) -> int:
    """Rows of the backward's f32 partial dw sums for this shape."""
    parts = _library().rms_norm_bwd_parts(rows, d, x_code, w_code, sms)
    if parts < 1:
        raise RuntimeError(f"rms_norm_bwd_parts refused rows={rows} d={d}")
    return parts


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def refusal(x: torch.Tensor, weight: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot normalise x by weight, or None where they can:
    x bf16 or f32, contiguous, its last dim d a multiple of 8 up to 8192;
    weight f32 or bf16, contiguous, of shape [d]; both 16-byte aligned
    (every activation and stacked layer leaf of the decoder arrives so).
    Reads only types, shapes, strides and addresses, so it needs no card."""
    if x.dtype not in _DTYPE_CODES or weight.dtype not in _DTYPE_CODES:
        return f"takes x and weight bf16 or f32, got {x.dtype}/{weight.dtype}"
    if x.dim() < 1 or weight.shape != x.shape[-1:]:
        return (f"takes weight of shape [d] for x [..., d], got {tuple(weight.shape)} "
                f"for {tuple(x.shape)}")
    d = x.shape[-1]
    if d % CHUNK or not CHUNK <= d <= MAX_D:
        return f"takes d a multiple of {CHUNK} from {CHUNK} to {MAX_D}, got d={d}"
    if not x.is_contiguous() or not weight.is_contiguous():
        return (f"takes x and weight contiguous, got strides {x.stride()} and "
                f"{weight.stride()}")
    if not (_aligned(x) and _aligned(weight)):
        return "takes x and weight 16-byte aligned"
    return None


def _forward(x: torch.Tensor, weight: torch.Tensor, eps: float,
             save: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y, and each row's f32 rstd where `save`; no launch for no rows."""
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device) if save else None
    if rows == 0:
        return y, rstd
    err = _library().rms_norm_fwd(
        x.data_ptr(), weight.data_ptr(), y.data_ptr(), rstd.data_ptr() if save else None,
        rows, d, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype],
        _sm_count(x.device.index), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm_fwd launch failed: CUDA error {err}")
    kernel_launches.inc(tags={"kernel": "rms_norm_fwd"})
    return y, rstd


def _backward(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, rstd: torch.Tensor,
              need_dx: bool, need_dw: bool
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """dx where `need_dx`, dw (in weight's type, its sum over the rows in
    f32) where `need_dw`; no launch for no rows."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} is not shaped as x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not dy.is_contiguous() or not _aligned(dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return (torch.empty_like(x) if need_dx else None,
                torch.zeros_like(weight) if need_dw else None)
    codes = _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype]
    parts = _bwd_parts(rows, d, *codes, _sm_count(x.device.index))
    dx = torch.empty_like(x) if need_dx else None
    partials = (torch.empty((parts, d), dtype=torch.float32, device=x.device)
                if need_dw else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _library()
    err = lib.rms_norm_bwd(x.data_ptr(), weight.data_ptr(), dy.data_ptr(), rstd.data_ptr(),
                           dx.data_ptr() if need_dx else None,
                           partials.data_ptr() if need_dw else None,
                           rows, d, parts, *codes, stream)
    if err != 0:
        raise RuntimeError(f"rms_norm_bwd launch failed: CUDA error {err}")
    kernel_launches.inc(tags={"kernel": "rms_norm_bwd"})
    if not need_dw:
        return dx, None
    dw = torch.empty_like(weight)
    err = lib.rms_norm_dw(partials.data_ptr(), dw.data_ptr(), parts, d, codes[1], stream)
    if err != 0:
        raise RuntimeError(f"rms_norm_dw launch failed: CUDA error {err}")
    kernel_launches.inc(tags={"kernel": "rms_norm_dw"})
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """y = rms_norm(x, weight); saves x, weight and each row's rstd."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        y, rstd = _forward(x, weight, eps, save=True)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = _backward(x, weight, dy, rstd, *ctx.needs_input_grad[:2])
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The norm of x's last dim by the kernels, x and weight on one CUDA
    device: one `rms_norm_fwd` launch, and where autograd records, one
    `rms_norm_bwd` and (for weight's gradient) one `rms_norm_dw` in the
    backward. Raises on tensors the kernels cannot take (`refusal`)."""
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"the RMSNorm kernels take x and weight on one CUDA device, got "
                         f"{x.device}/{weight.device}")
    why = refusal(x, weight)
    if why is not None:
        raise ValueError(f"the RMSNorm kernels {why}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _forward(x, weight, eps, save=False)[0]


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of `dtype` (bf16 or f32) at each |x|, in f64, the subnormal
    step at least."""
    mant, least = (8, -133) if dtype == torch.bfloat16 else (24, -149)
    _, e = torch.frexp(x.double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), (e - mant).clamp(min=least))


def f64_reference(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                  eps: float) -> dict:
    """y = x r T(w), r = rsqrt(mean(x^2) + eps), and its dx and dw by f64
    autograd, each with its tolerance (TERM_SHARE of its terms' magnitude
    plus one ulp of its type): {"y": (ref, tol), "dx": ..., "dw": ...};
    "r" is each row's f64 r, [..., 1]. The kernels' plain reference on any
    device."""
    x64 = x.double().requires_grad_(True)
    w64 = weight.to(x.dtype).double().requires_grad_(True)
    dy64 = dy.double()
    r = torch.rsqrt(torch.mean(x64 * x64, dim=-1, keepdim=True) + eps)
    y64 = x64 * r * w64
    dx, dw = torch.autograd.grad(y64, (x64, w64), dy64)
    with torch.no_grad():
        share = TERM_SHARE[x.dtype]
        r, xd, y64 = r.detach(), x64.detach(), y64.detach()
        dn = (dy64 * w64.detach()).abs()
        dx_mag = r * dn + xd.abs() * r ** 3 * (dn * xd.abs()).sum(-1, keepdim=True) / x.shape[-1]
        dw_mag = (dy64 * xd * r).abs().sum(tuple(range(x.dim() - 1)))
        return {"r": r,
                "y": (y64, share * y64.abs() + ulp(y64, x.dtype)),
                "dx": (dx, share * dx_mag + ulp(dx, x.dtype)),
                "dw": (dw, share * dw_mag + ulp(dw, weight.dtype))}
