"""Collectives on device tensors, port of the device half of
`ray_tpu/parallel/collectives.py` (`device_allreduce`, :301-333), and the
autograd-aware collectives that the sharded forward issues where XLA
inserts them for the JAX package.

Over the `tensor` axis a layer's result is replicated on every rank of the
group, so the gradient that reaches a collective is replicated too, and a
summing backward would count it once per rank. The conjugate pair of
Megatron-LM places the sums where they belong:

- `copy_to` (f): identity forward, all-reduce backward, at the input of a
  column-parallel product (each rank's input gradient is a partial sum);
- `reduce_from` (g): all-reduce forward, identity backward, after a
  row-parallel product and the vocab-parallel embedding;
- `gather_from`: all-gather forward, split backward, for the logits.

Over the axes that split the batch the ranks' losses differ, and there a
summing backward is right: `gather_shards` is fsdp's per-use weight
all-gather, whose backward reduce-scatters the gradients.

The host `CollectiveGroup` (`collectives.py:135-292`) rides on the ray_tpu
runtime and comes with its port (ROADMAP A7/A14).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.sharding import all_gather_dim

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def device_allreduce(x: torch.Tensor, mesh, axis: str = "data", op: str = "sum") -> torch.Tensor:
    """All-reduce of this rank's `x` over the mesh axis `axis`: a new tensor
    with the sum, mean, max or min over the ranks of the axis (every rank of
    the mesh calls it). The JAX package's version reduces the shards of one
    global array, which is what each rank's `x` is here."""
    try:
        reduce_op = _REDUCE_OPS[op]
    except KeyError:
        raise ValueError(f"unknown op {op!r}; options {sorted(_REDUCE_OPS)}")
    group = mesh.get_group(axis)
    out = x.detach().clone()
    dist.all_reduce(out, op=reduce_op, group=group)
    if op == "mean":
        out /= dist.get_world_size(group)
    return out


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim)[dist.get_rank(group)].contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over `group` of `x`, split along `dim`: this rank's part."""
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim))  # [n, ...] in group-rank order
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    # The tensor form's name varies across torch versions.
    reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    reduce_scatter(out, parts.reshape((-1,) + tuple(out.shape[1:])), group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(g, ctx.group, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """f: identity forward, all-reduce over `group` backward."""
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """g: all-reduce over `group` forward, identity backward."""
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int) -> torch.Tensor:
    """All-gather along `dim` over `group` forward; backward, this rank's
    slice of the (replicated) gradient."""
    return x if _trivial(group) else _GatherFrom.apply(x, group, dim % x.dim())


def gather_shards(x: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int) -> torch.Tensor:
    """All-gather along `dim` over `group` forward; backward, the
    reduce-scatter of the gradient: the sum over the ranks, whose
    contributions differ, of this rank's slice."""
    return x if _trivial(group) else _GatherShards.apply(x, group, dim % x.dim())
