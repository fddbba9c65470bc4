"""Attention ops, port of `ray_tpu/ops/attention.py`: the materialised
reference, the blockwise online-softmax scan and the dispatcher.

Shapes follow [batch, seq, heads, head_dim] throughout. GQA is expressed by
n_kv_heads < n_heads; kv heads are repeated on the fly, each group kept
contiguous (`repeat_interleave`, as `jnp.repeat` does).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, H, D] by repeating groups (GQA)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    if n_heads % n_kv != 0:
        raise ValueError(f"n_heads={n_heads} is not a multiple of n_kv_heads={n_kv}")
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """O(S^2) materialised-scores attention. Ground truth for tests.

    q_offset: absolute position of q[0] relative to k[0] (decode/ring steps).
    """
    b, sq, h, d = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, NEG_INF)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    # The probabilities are cast to v's type before the PV product.
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_size: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash-attention semantics in plain PyTorch: a loop over KV blocks with
    an online softmax, never materialising the [S, S] score matrix."""
    b, sq, h, d = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    if sk % block_size != 0:
        block_size = sk  # fall back to one block rather than pad

    qf = (q * scale).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    qpos = torch.arange(sq, device=q.device) + q_offset

    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, sk, block_size):
        kb = kf[:, start : start + block_size]
        vb = vf[:, start : start + block_size]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        if causal:
            kpos = torch.arange(start, start + block_size, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            logits = logits.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # Guard: a fully-masked row has logits == m_new == NEG_INF; exp(0)=1
        # would poison l. Force those probabilities to 0.
        p = torch.where(
            logits <= NEG_INF / 2,
            torch.zeros((), dtype=torch.float32, device=q.device),
            torch.exp(logits - m_new[..., None]),
        )
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.transpose(1, 2).to(q.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_size: int = 512,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Dispatching attention entry point used by models/.

    impl: None (auto) | "reference" | "blockwise" | "flash", or "pallas",
    the JAX package's name for its kernel path, which takes the same kernels.
    Auto picks the hand-written flash kernel for tensors on a CUDA device when
    the shapes are tile-aligned (seq % 128 and head_dim % 128, the same rule
    the JAX package applies on a TPU), else the blockwise loop for long
    sequences and the reference for short ones.
    """
    if impl is None:
        if (
            q.is_cuda
            and q.shape[1] % 128 == 0
            and k.shape[1] % 128 == 0
            and q.shape[-1] % 128 == 0
        ):
            impl = "flash"
        elif q.shape[1] > block_size:
            impl = "blockwise"
        else:
            impl = "reference"
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, scale=scale, block_size=block_size)
    if impl in ("flash", "pallas"):
        from ray_tpu_torch.ops.cuda.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
