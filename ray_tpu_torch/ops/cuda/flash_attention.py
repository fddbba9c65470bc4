"""Flash attention: hand-written CUDA kernels for Hopper (sm_90a), their
plain PyTorch versions, and the autograd Function that joins them.

Replaces the TPU kernels of `ray_tpu/ops/pallas/flash_attention.py`:

- B1, the forward `_fwd_kernel` launched by `_flash_fwd` (:55-145), in
  `ray_tpu_torch/csrc/flash_attn_fwd.cu`;
- B2 and B3, the backward `_bwd_dq_kernel` and `_bwd_dkv_kernel` launched by
  `_flash_bwd` (:151-319), in `ray_tpu_torch/csrc/flash_attn_bwd.cu`;
- `_FlashAttention` mirrors the `jax.custom_vjp` wiring (:329-355).

Each source's header says what bounds its kernels on the card and what the
design does about it. The bf16 kernels read their inputs by TMA:
`tma_layout` computes, here in Python, the dims, byte strides and box of
each tensor map, and `fwd_layout`, `dq_layout` and `dkv_layout` the maps
and the grid from the tiles that the library sets (`kernel_tiles`); the
CUDA side encodes the maps from those numbers and launches that grid. For
tensors on the CPU the wrappers compute the plain versions. For tensors on
a CUDA device they launch the kernels or raise; they never fall back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.ops.attention import NEG_INF, _repeat_kv
from ray_tpu_torch.ops.cuda._build import kernel_launches, load_library

SOURCE = "flash_attn_fwd.cu"
BWD_SOURCE = "flash_attn_bwd.cu"
HEAD_DIMS = (64, 128)  # head dims the kernels are instantiated for
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_MAX_GRID_Y = 65535
# Rows of the f32 kernels' q or kv tiles, which the grid's y dimension (at
# most 65535) runs over. The bf16 kernels have a 1-d grid over tiles that
# their library sets (`kernel_tiles`).
_F32_TILE_ROWS = 16
_ENCODE_FAILED = 999  # the CUDA side's code for a tensor map the CUDA driver refused


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, S, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"mismatched shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"n_heads={h} is not a multiple of n_kv_heads={k.shape[2]}")


def _kernel_readable(t: torch.Tensor) -> bool:
    """The kernels read [B, S, H, D] tensors whose last dim is contiguous:
    f32 by their strides, bf16 by TMA, so a bf16 tensor must also have what
    `tma_layout` asks, a 16-byte-aligned base and strides that are positive
    multiples of 16 bytes (a broadcast dim, of stride 0, has not)."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    try:
        tma_layout(t, 1, 1)
    except ValueError:
        return False
    return True


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernels do not take. Reads only shapes,
    types, strides and addresses, so it needs no card."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash kernel takes bf16 or f32 q/k/v of one type, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}/{k.device}/{v.device}")
    longest = max(q.shape[1], k.shape[1])
    if q.dtype == torch.float32 and -(-longest // _F32_TILE_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"sequence too long for the f32 kernels' grid: {longest}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_readable(t):
            raise ValueError(
                f"{name} must be contiguous in its last dim and, for bf16, have a "
                f"16-byte-aligned base and strides that are positive multiples of 16 bytes"
            )


def tma_layout(t: torch.Tensor, rows: int, cols: int) -> Tuple[int, ...]:
    """The numbers a TMA tensor map of a [B, S, H, D] bf16 tensor is encoded
    from, read in boxes of `rows` rows by up to `cols` columns: dims (D, S,
    H, B), innermost first; byte strides of S, H and B; box (columns, rows).
    A size-1 dim's stride is never used, and is given the stride a
    contiguous tensor would have (the CUDA driver checks every stride).
    Raises ValueError where TMA cannot read the tensor: a strided last dim,
    or a base address or stride that is not a positive multiple of 16
    bytes. Reads only shapes, strides and the address, so it needs no
    card."""
    if t.dim() != 4 or t.dtype != torch.bfloat16:
        raise ValueError(
            f"TMA maps are built for bf16 [B, S, H, D], got {t.dtype} {tuple(t.shape)}"
        )
    if t.data_ptr() % 16:
        raise ValueError("TMA needs a 16-byte-aligned base address")
    return _tma_numbers(tuple(t.shape), t.stride(), rows, cols)


@functools.lru_cache(maxsize=1024)
def _tma_numbers(shape: Tuple[int, ...], strides: Tuple[int, ...], rows: int,
                 cols: int) -> Tuple[int, ...]:
    """`tma_layout` from a bf16 tensor's shape and element strides; the
    wrapper calls it for every launch, so its answers are kept."""
    b, s, h, d = shape
    if strides[3] != 1:
        raise ValueError("TMA reads rows whose last dim is contiguous")
    nbytes_of = []
    prev_stride, prev_size = 2, d
    for size, stride in ((s, strides[1]), (h, strides[2]), (b, strides[0])):
        nbytes = stride * 2 if size > 1 else prev_stride * prev_size
        if nbytes <= 0 or nbytes % 16 or nbytes >= 1 << 40:
            raise ValueError(
                f"TMA needs strides that are positive multiples of 16 bytes, got {nbytes}"
            )
        nbytes_of.append(nbytes)
        prev_stride, prev_size = nbytes, size
    return (d, s, h, b, *nbytes_of, min(d, cols), rows)


@dataclasses.dataclass(frozen=True)
class KernelLayout:
    """What one bf16 launch of B1, B2 or B3 is built from: the tensor maps'
    numbers by operand name (`tma_layout`) and the grid: one dimension, a
    block per tile of each head, the blocks of one head adjacent so that
    they share its streamed operands through L2."""

    maps: Dict[str, Tuple[int, ...]]
    blocks: int

    def array(self) -> ctypes.Array:
        """The maps' numbers in launch order, then the block count, as the
        CUDA side reads them."""
        flat = [n for m in self.maps.values() for n in m] + [self.blocks]
        return (ctypes.c_longlong * len(flat))(*flat)


def _maps(names, tensors, tiles) -> Dict[str, Tuple[int, ...]]:
    *rows, cols = tiles
    return {n: tma_layout(t, r, cols) for n, t, r in zip(names, tensors, rows)}


def fwd_layout(q, k, v, o, tiles: Sequence[int]) -> KernelLayout:
    """B1: `tiles` holds the rows of the q, k, v and o boxes, then their
    columns, as `kernel_tiles("fwd")` reads them from the library; a block
    per q tile of each (b, h). Raises ValueError where TMA cannot read or
    write an operand."""
    b, sq, h, _ = q.shape
    return KernelLayout(maps=_maps(("q", "k", "v", "o"), (q, k, v, o), tiles),
                        blocks=b * h * -(-sq // tiles[0]))


def dq_layout(q, k, v, do, tiles: Sequence[int]) -> KernelLayout:
    """B2: `tiles` holds the rows of the q, k, v and dO boxes, then their
    columns, as `kernel_tiles("dq")` reads them from the library; a block
    per q tile of each (b, h), the q heads of one kv head adjacent. Raises
    ValueError where TMA cannot read an operand."""
    b, sq, h, _ = q.shape
    return KernelLayout(maps=_maps(("q", "k", "v", "do"), (q, k, v, do), tiles),
                        blocks=b * h * -(-sq // tiles[0]))


def dkv_layout(q, k, v, do, tiles: Sequence[int]) -> KernelLayout:
    """B3: `tiles` holds the rows of the q, k, v and dO boxes, then their
    columns, as `kernel_tiles("dkv")` reads them from the library; a block
    per kv tile of each (b, h_kv). Raises ValueError where TMA cannot read
    an operand."""
    b, sk, hkv, _ = k.shape
    return KernelLayout(maps=_maps(("q", "k", "v", "do"), (q, k, v, do), tiles),
                        blocks=b * hkv * -(-sk // tiles[1]))


# Library, source and function that report each bf16 TMA kernel's tiles.
_TILES_FROM = {"fwd": ("flash_attn_fwd", SOURCE, "flash_attn_fwd_tiles"),
               "dq": ("flash_attn_bwd", BWD_SOURCE, "flash_attn_bwd_dq_tiles"),
               "dkv": ("flash_attn_bwd", BWD_SOURCE, "flash_attn_bwd_dkv_tiles")}


@functools.lru_cache(maxsize=None)
def kernel_tiles(kernel: str) -> Tuple[int, ...]:
    """The box rows of each operand of the bf16 `kernel` ("fwd", "dq" or
    "dkv"), in launch order, then the boxes' columns, as its library sets
    them. Builds the library."""
    lib_name, source, fn_name = _TILES_FROM[kernel]
    out = (ctypes.c_int * 5)()
    getattr(load_library(lib_name, [source]), fn_name)(out)
    return tuple(out)


def _launch_error(name: str, err: int) -> RuntimeError:
    if err == _ENCODE_FAILED:
        return RuntimeError(f"{name}: the CUDA driver refused a TMA tensor map")
    return RuntimeError(f"{name} launch failed: CUDA error {err}")


def _visible(sq: int, sk: int, device) -> torch.Tensor:
    """Causal mask [Sq, Sk]: key k is visible to query q when k <= q."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    return qpos >= kpos


# -- B1: forward ------------------------------------------------------------


def flash_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: f32 scores over the whole
    sequence, the same masking and guards. Returns (o [B,S,H,D] in q's type,
    lse [B,H,S,1] f32)."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    qf = q.to(torch.float32) * scale  # the scale is applied to q in f32
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(torch.float32))
    if causal:
        logits = logits.masked_fill(~_visible(sq, k.shape[1], q.device), NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(
        logits <= NEG_INF / 2,
        torch.zeros((), dtype=torch.float32, device=q.device),
        torch.exp(logits - m),
    )
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.to(torch.float32)) / l_safe
    return o.transpose(1, 2).to(q.dtype), m + torch.log(l_safe)


@functools.lru_cache(maxsize=None)
def _fwd_function() -> ctypes._CFuncPtr:
    """The forward entry point, its types declared once (the wrapper's host
    time a call is part of every serving batch)."""
    fn = load_library("flash_attn_fwd", [SOURCE]).flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 12
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def _launch(q, k, v, causal: bool, scale: float):
    _check_kernel_inputs(q, k, v)
    fn = _fwd_function()
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    maps = (fwd_layout(q, k, v, o, kernel_tiles("fwd")).array()
            if q.dtype == torch.bfloat16 else None)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, k.shape[2], sq, k.shape[1], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        maps, scale, int(causal), stream,
    )
    if err != 0:
        raise _launch_error("flash_attn_fwd", err)
    kernel_launches.inc(tags={"kernel": "flash_attn_fwd"})
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward, [B, S, H, D] layout, GQA by kv head
    h // (H / Hkv). Returns (o in q's type, lse f32 [B, H, S, 1]), as the JAX
    package's `_flash_fwd` does. Any sequence length works: the kernel masks
    the ragged edge itself."""
    _check_shapes(q, k, v)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got {q.device}")
    return _launch(q, k, v, causal, scale)


# -- B2 and B3: backward ----------------------------------------------------


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels, by their formulas (no
    autograd): f32 scores over the whole sequence, P = exp(q_s k^T - lse)
    with masked entries 0, dS = P * (dO v^T - delta), dq = scale * dS k,
    dk = dS^T q_s, dv = P^T dO, dk and dv summed over each GQA group.
    delta is rowsum(dO * o) f32 [B, H, Sq], computed from o unless given.
    Returns (dq, dk, dv) in q's, k's and v's types."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    f32 = torch.float32
    qs = q.to(f32) * scale
    kf = _repeat_kv(k, h).to(f32)
    vf = _repeat_kv(v, h).to(f32)
    dof = do.to(f32)
    # delta comes from the saved o, as the JAX package computes it.
    delta = (_delta(do, o) if delta is None else delta)[..., None]  # [B, H, Sq, 1]
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, kf) - lse)
    if causal:
        p = p.masked_fill(~_visible(sq, sk, q.device), 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    if hkv != h:
        dk = dk.reshape(b, sk, hkv, h // hkv, d).sum(3)
        dv = dv.reshape(b, sk, hkv, h // hkv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# Pointer arguments of each entry point before its ints; after them come
# two more, the strides and the tensor maps' numbers.
_BWD_POINTERS = {"flash_attn_bwd_dq": 7, "flash_attn_bwd_dkv": 8}


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The backward library, its entry points' types declared once."""
    lib = load_library("flash_attn_bwd", [BWD_SOURCE])
    for name, n_ptr in _BWD_POINTERS.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 2
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return lib


def _delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * o) in f32 from the saved o, [B, H, Sq]: outside
    the kernels, as the JAX package computes it outside Pallas."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _BwdLaunch:
    """One backward on the card: checks the inputs, computes delta unless
    it is given, allocates dq, dk and dv, and holds every tensor the kernels
    read while they may run. `dq()` launches B2 and `dkv()` launches B3."""

    def __init__(self, q, k, v, o, lse, do, causal: bool, scale: float,
                 delta: Optional[torch.Tensor] = None):
        _check_kernel_inputs(q, k, v)
        b, sq, h, d = q.shape
        if o.shape != q.shape or do.shape != q.shape:
            raise ValueError(
                f"o {tuple(o.shape)} and dO {tuple(do.shape)} must match q {tuple(q.shape)}"
            )
        if do.dtype != q.dtype or do.device != q.device:
            raise TypeError(f"dO must be {q.dtype} on {q.device}, got {do.dtype} on {do.device}")
        if lse.shape != (b, h, sq, 1) or lse.dtype != torch.float32:
            raise ValueError(f"lse must be f32 [B, H, Sq, 1], got {lse.dtype} {tuple(lse.shape)}")
        # The gradient autograd hands over may have any strides (the
        # backward of an einsum permutes them; that of a sum over S
        # broadcasts, with stride 0): copy it where the kernels cannot read
        # it (a fresh allocation, which is aligned even where the tensor is
        # contiguous but its rows are not).
        if not _kernel_readable(do):
            do = do.clone(memory_format=torch.contiguous_format)
        lse = lse.contiguous()
        if delta is None:
            delta = _delta(do, o)
        elif (delta.shape != (b, h, sq) or delta.dtype != torch.float32
              or delta.device != q.device):
            raise ValueError(f"delta must be f32 [B, H, Sq] on {q.device}, got "
                             f"{delta.dtype} {tuple(delta.shape)} on {delta.device}")
        delta = delta.contiguous()
        self.dq_out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        self.dk_out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        self.dv_out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        self._keep = (q, k, v, do, lse, delta)
        self._strides = (ctypes.c_longlong * 21)(
            *(s for t in (q, k, v, do, self.dq_out, self.dk_out, self.dv_out)
              for s in t.stride()[:3])
        )
        bf16 = q.dtype == torch.bfloat16
        self._dq_maps = dq_layout(q, k, v, do, kernel_tiles("dq")).array() if bf16 else None
        self._dkv_maps = dkv_layout(q, k, v, do, kernel_tiles("dkv")).array() if bf16 else None
        self._inputs = tuple(t.data_ptr() for t in self._keep)
        self._ints = (_DTYPE_CODES[q.dtype], b, h, k.shape[2], sq, k.shape[1], d,
                      ctypes.cast(self._strides, ctypes.c_void_p))
        self._tail = (scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream)
        self._lib = _bwd_library()

    def dq(self) -> None:
        err = self._lib.flash_attn_bwd_dq(
            *self._inputs, self.dq_out.data_ptr(), *self._ints, self._dq_maps, *self._tail
        )
        if err != 0:
            raise _launch_error("flash_attn_bwd_dq", err)
        kernel_launches.inc(tags={"kernel": "flash_attn_bwd_dq"})

    def dkv(self) -> None:
        err = self._lib.flash_attn_bwd_dkv(
            *self._inputs, self.dk_out.data_ptr(), self.dv_out.data_ptr(), *self._ints,
            self._dkv_maps, *self._tail,
        )
        if err != 0:
            raise _launch_error("flash_attn_bwd_dkv", err)
        kernel_launches.inc(tags={"kernel": "flash_attn_bwd_dkv"})


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward from the forward's saved (q, k, v, o, lse)
    and the output's gradient dO, [B, S, H, D] layout, as the JAX package's
    `_flash_bwd`. Returns (dq, dk, dv) in q's, k's and v's types; dk and dv
    hold the sums over each GQA group. `delta`, rowsum(dO * o) f32
    [B, H, Sq], is computed from o unless given: ring attention computes it
    once for all its chunk pairs, from the merged output."""
    _check_shapes(q, k, v)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale,
                                         delta=delta)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got {q.device}")
    call = _BwdLaunch(q, k, v, o, lse, do, causal, scale, delta)
    call.dq()
    call.dkv()
    return call.dq_out, call.dk_out, call.dv_out


class _FlashAttention(torch.autograd.Function):
    """Forward B1, backward B2 and B3, as `_flash` with its custom VJP.
    Saves (q, k, v, o, lse) only when autograd records."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention, [B, S, H, D] layout; returns o, with gradients to q,
    k and v through the backward kernels."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale)
