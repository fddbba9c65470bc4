"""Ring attention over a sequence-sharded axis, port of
`ray_tpu/ops/ring_attention.py`.

Each rank of the ring holds one chunk of the sequence, q, k and v alike;
k/v chunks rotate around the ring (`dist.batch_isend_irecv`, the next
chunk's transfer under this one's compute) while each rank attends its q
chunk to them. The JAX package computes online-softmax partials in plain
jnp for every chunk pair and masks by absolute position; the port runs the
hand-written flash kernels per chunk pair instead. The chunks are of equal
length, so no pair needs a position offset:

- a chunk from an earlier rank (src < my) is wholly visible: B1 with
  causal=False;
- the rank's own chunk (src == my) is the diagonal: B1 with causal=True;
- a chunk from a later rank (src > my) is wholly masked, so it is skipped
  (the JAX package's masked steps add exactly zero).

The partials (o_i, lse_i), each normalised by its own softmax, merge in
f32 in lse form: lse = logsumexp_i lse_i, o = Σ_i exp(lse_i - lse)·o_i.
The backward is a second ring: B2 and B3 per visible pair with the merged
o and lse, so P = exp(s - lse) is the global softmax; δ = rowsum(dO·o) is
computed once, dq sums in f32 on its rank, and the f32 dk/dv sums travel
with their k/v chunk and reach its owner after n steps. k and v rotate with
their own (GQA) head count; the kernels index kv head h // (H/Hkv).

On CPU tensors each step runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.cuda.flash_attention import (
    _delta,
    flash_attention_bwd,
    flash_attention_fwd,
)
from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
from ray_tpu_torch.parallel.sharding import gather_tensor, placement, shard_index, shard_tensor


def ring_step_forward(q, k, v, *, my: int, src: int, causal: bool,
                      scale: float) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(o, lse) of the q chunk of ring position `my` against the k/v chunk
    of position `src`, or None where causality hides the whole chunk."""
    if causal and src > my:
        return None
    return flash_attention_fwd(q, k, v, causal=causal and src == my, scale=scale)


def merge_partials(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge partials (o_i [B,S,H,D], lse_i f32 [B,H,S,1]), each normalised
    by its own softmax, in f32: (o in o_i's type, lse f32 [B,H,S,1])."""
    lse = torch.logsumexp(torch.stack([l for _, l in parts]), dim=0)
    out = None
    for o_i, lse_i in parts:
        w = torch.exp(lse_i - lse).transpose(1, 2)  # [B, S, H, 1]
        term = o_i.float() * w
        out = term if out is None else out.add_(term)
    return out.to(parts[0][0].dtype), lse


def ring_step_backward(q, k, v, o, lse, do, delta, *, my: int, src: int, causal: bool,
                       scale: float) -> Optional[Tuple[torch.Tensor, ...]]:
    """(dq, dk, dv) of one chunk pair from the merged o and lse and the
    shared delta, or None where causality hides the whole chunk."""
    if causal and src > my:
        return None
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal and src == my, scale=scale,
                               delta=delta)


def ring_schedule(q, k, v, do=None, *, n: int, causal: bool = True,
                  scale: Optional[float] = None):
    """The ring's chunk schedule for a ring of `n`, run in one process on
    whole [B, S, H(kv), D] tensors (S a multiple of n): for each ring
    position, its forward steps in ring order and their merge, then, with
    `do`, its backward steps with the merged o and lse and one delta,
    through the functions `ring_attention` runs on each rank. It holds the
    kernels on the ring's path against whole-sequence attention on one
    card. Returns (o, lse), and with `do` (o, lse, dq, dk, dv), of the
    whole sequence."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    c = q.shape[1] // n
    qs, ks, vs = (t.split(c, dim=1) for t in (q, k, v))
    dos = do.split(c, dim=1) if do is not None else None
    outs, lses, dqs = [], [], []
    dk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in ks]
    dv = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in vs]
    for my in range(n):
        srcs = [(my - s) % n for s in range(n)]
        parts = [ring_step_forward(qs[my], ks[src], vs[src], my=my, src=src, causal=causal,
                                   scale=scale) for src in srcs]
        o, lse = merge_partials([p for p in parts if p is not None])
        outs.append(o)
        lses.append(lse)
        if dos is None:
            continue
        delta = _delta(dos[my], o)
        dq = torch.zeros(qs[my].shape, dtype=torch.float32, device=q.device)
        for src in srcs:
            grads = ring_step_backward(qs[my], ks[src], vs[src], o, lse, dos[my], delta, my=my,
                                       src=src, causal=causal, scale=scale)
            if grads is not None:
                dq += grads[0].float()
                dk[src] += grads[1].float()
                dv[src] += grads[2].float()
        dqs.append(dq)
    o, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=2)
    if dos is None:
        return o, lse
    return (o, lse, torch.cat(dqs, dim=1).to(q.dtype), torch.cat(dk, dim=1).to(k.dtype),
            torch.cat(dv, dim=1).to(v.dtype))


def _rotate(tensors: Sequence[torch.Tensor], group, ranks: List[int], my: int):
    """Start sending `tensors` to the next rank of the ring and receiving
    the previous rank's; returns (received buffers, requests)."""
    n = len(ranks)
    nxt, prv = ranks[(my + 1) % n], ranks[(my - 1) % n]
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    return recv, dist.batch_isend_irecv(ops)


def _wait(pending):
    recv, reqs = pending
    for r in reqs:
        r.wait()
    return recv


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        ranks = dist.get_process_group_ranks(group)
        n, my = len(ranks), dist.get_rank(group)
        kc, vc = k.contiguous(), v.contiguous()
        parts = []
        for s in range(n):
            pending = _rotate((kc, vc), group, ranks, my) if s < n - 1 else None
            part = ring_step_forward(q, kc, vc, my=my, src=(my - s) % n, causal=causal,
                                     scale=scale)
            if part is not None:
                parts.append(part)
            if pending is not None:
                kc, vc = _wait(pending)
        o, lse = merge_partials(parts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        ranks = dist.get_process_group_ranks(group)
        n, my = len(ranks), dist.get_rank(group)
        delta = _delta(do, o)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc = k.contiguous(), v.contiguous()
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for s in range(n):
            pending = _rotate((kc, vc), group, ranks, my) if s < n - 1 else None
            grads = ring_step_backward(q, kc, vc, o, lse, do, delta, my=my, src=(my - s) % n,
                                       causal=ctx.causal, scale=ctx.scale)
            if grads is not None:
                dq += grads[0].float()
                dk += grads[1].float()
                dv += grads[2].float()
            if pending is not None:
                kc, vc = _wait(pending)
            if n > 1:  # the sums move on with their chunk; after n moves they are home
                dk, dv = _wait(_rotate((dk, dv), group, ranks, my))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: dist.ProcessGroup,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Per-rank body: q, k, v are this rank's chunks [B, S_local, H(kv), D]
    of a sequence that is their concatenation over `group`'s ranks in rank
    order. Returns this rank's chunk of the output, in q's type, with
    gradients to q, k and v through the ring's backward. Every rank of the
    group calls it."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, group, causal, scale)


def select_kv_heads(k: torch.Tensor, n_heads: int, rank: int, size: int) -> torch.Tensor:
    """The kv heads [.., S, Hkv, D] that the q heads of rank `rank` of
    `size` (a contiguous share of `n_heads`) read, laid out so that local q
    head h reads local kv head h // (H_local / Hkv_local): where kv heads
    do not divide over the ranks that split the q heads, every rank keeps
    the kv heads of its own q heads."""
    per_rank, group = n_heads // size, n_heads // k.shape[-2]
    wanted = [(rank * per_rank + h) // group for h in range(per_rank)]
    first, count = wanted[0], wanted[-1] - wanted[0] + 1
    if per_rank % count == 0 and all(
            w == first + h // (per_rank // count) for h, w in enumerate(wanted)):
        return k.narrow(-2, first, count)
    return k[..., wanted, :]  # one kv head per q head


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    seq_axis: str = "seq",
    batch_axes=("data", "fsdp"),
    head_axis: Optional[str] = "tensor",
    causal: bool = True,
) -> torch.Tensor:
    """Convenience wrapper: ring attention over a mesh, for global
    [B, S, H, D] inputs that every rank holds. Each rank takes its shard (S
    over seq_axis, B over batch_axes, heads over head_axis, shape-fitted as
    in the JAX package: a dim that does not divide runs replicated), runs
    `ring_attention` over the seq axis and returns the global output,
    gathered back on every rank, without gradients (training runs
    `ring_attention` on each rank's chunks, as the model does). S must
    divide over the seq axis."""
    sizes = mesh_axis_sizes(mesh)
    rules = {"b": batch_axes, "s": seq_axis, "h": head_axis}

    def fit(x):
        place = placement(x.shape, ("b", "s", "h", None), rules, sizes)
        if sizes[seq_axis] > 1 and place[1] != (seq_axis,):
            raise ValueError(
                f"seq length {x.shape[1]} not divisible by mesh axis "
                f"{seq_axis!r} ({sizes[seq_axis]})"
            )
        return place

    q_place, k_place = fit(q), fit(k)
    q_local = shard_tensor(q, q_place, mesh)
    k_local, v_local = shard_tensor(k, k_place, mesh), shard_tensor(v, k_place, mesh)
    if q_place[2] and not k_place[2]:  # q heads split, kv heads replicated
        head_rank, head_count = shard_index(q_place[2], mesh)
        k_local = select_kv_heads(k_local, q.shape[2], head_rank, head_count)
        v_local = select_kv_heads(v_local, q.shape[2], head_rank, head_count)
    if sizes[seq_axis] > 1:
        out = ring_attention(q_local, k_local, v_local, group=mesh.get_group(seq_axis),
                             causal=causal)
    else:
        out, _ = flash_attention_fwd(q_local, k_local, v_local, causal=causal)
    return gather_tensor(out, q_place, mesh)
