"""The optimizer's update after the global norm (clip_by_global_norm, then
AdamW) as one hand-written CUDA kernel for Hopper (sm_90a), one launch a
leaf: `clip_adamw`.

It replaces no Pallas kernel (the JAX package leaves the update to XLA's
fusion of optax's chain). Its plain version is `_clip_adamw_plain` in
`ray_tpu_torch/models/lm.py`, the chain of `_foreach` passes that
`default_optimizer` runs for leaves off the card; `ray_tpu_torch/csrc/adamw.cu`
says what bounds the kernel and what its design does about it. For CUDA
leaves `default_optimizer` launches the kernel or raises; it never falls
back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence

import torch

from ray_tpu_torch.ops.cuda._build import load_library

SOURCE = "adamw.cu"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _function() -> ctypes._CFuncPtr:
    """The entry point, its types declared once."""
    fn = load_library("adamw", [SOURCE]).adamw_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def refusal(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
            nu: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot update this leaf, or None where it can: it
    takes p, g, mu and nu of one type, f32 or bf16, one shape, and each
    contiguous, so that element i of one is element i of the others in
    storage (every gradient and state of the benchmark's training arrives
    so). Reads only types, shapes and strides, so it needs no card."""
    four = (p, g, mu, nu)
    if p.dtype not in _DTYPE_CODES or any(t.dtype != p.dtype for t in four):
        return (f"takes p, g, mu and nu all f32 or all bf16, got "
                f"{'/'.join(str(t.dtype) for t in four)}")
    if any(t.shape != p.shape for t in four):
        return f"p, g, mu and nu differ in shape: {'/'.join(str(tuple(t.shape)) for t in four)}"
    if not all(t.is_contiguous() for t in four):
        return (f"takes p, g, mu and nu contiguous, got strides "
                f"{'/'.join(str(t.stride()) for t in four)}")
    return None


def clip_adamw(grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
               nu: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               grad_norm: torch.Tensor, count: int, *, learning_rate: float,
               weight_decay: float, b1: float, b2: float, eps: float,
               max_norm: float) -> None:
    """clip_by_global_norm(max_norm) then adamw on CUDA leaves, in place:
    one kernel launch a leaf updates its parameter and moments; `count` is
    the step count after this update, `grad_norm` the gradients' global
    norm, read on the device (no host sync). The gradients are read, not
    clipped in place. Raises on lists of unequal lengths and, naming the
    leaf, on a leaf the kernel cannot take (`refusal`) or one not on the
    norm's CUDA device."""
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"{len(params)} params, {len(grads)} gradients, {len(mu)} mu and "
                         f"{len(nu)} nu: one of each a leaf")
    device = grad_norm.device
    if device.type != "cuda":
        raise ValueError(f"the clip + AdamW kernel needs the norm on a CUDA device, got {device}")
    norm = grad_norm.detach().to(torch.float32).reshape(())
    leaves = list(zip(params, grads, mu, nu))
    for i, four in enumerate(leaves):
        if any(t.device != device for t in four):
            raise ValueError(f"leaf {i} {tuple(four[0].shape)}: p, g, mu and nu must be on "
                             f"{device}, got {'/'.join(str(t.device) for t in four)}")
        why = refusal(*four)
        if why is not None:
            raise ValueError(f"leaf {i} {tuple(four[0].shape)}: the clip + AdamW kernel {why}")
    # Each constant rounded to f32 from the double the plain chain passes.
    hyper = (ctypes.c_float * 10)(max_norm, b1, 1 - b1, b2, 1 - b2, 1 - b1 ** count,
                                  1 - b2 ** count, eps, weight_decay, -learning_rate)
    fn, sms = _function(), _sm_count(device.index)
    stream = torch.cuda.current_stream(device).cuda_stream
    for i, (p, g, m, v) in enumerate(leaves):
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                 _DTYPE_CODES[p.dtype], norm.data_ptr(), hyper, sms, stream)
        if err != 0:
            raise RuntimeError(f"adamw_update launch failed on leaf {i}: CUDA error {err}")
        with _count_lock:
            clip_adamw.launches += 1


# Kernel launches made by this process (one a leaf an update); chip_smoke.py
# sets it to 0 before each training path and reads it after.
clip_adamw.launches = 0
