"""Pipeline parallelism, port of `ray_tpu/parallel/pipeline.py`: GPipe
microbatch pipelining and the 1F1B schedule over the `pipeline` mesh axis.

Each rank of the pipeline axis holds one stage's parameters; microbatches
stream through the stages, and a stage hands its output to the next one
(`dist.batch_isend_irecv` over the pipeline group, where the JAX package
runs `ppermute`). The JAX package differentiates its schedule, a
`lax.scan`, straight through the hops. In torch each rank's autograd graph
would end at its sends and receives, and the autograd engine does not
promise to run the hops' backwards in the same order on every rank, where
a mismatch of blocking pairs hangs. So a stage's whole GPipe schedule is
one `torch.autograd.Function` (`_GPipe`): its forward runs the ticks and
keeps each microbatch's graph, from an input detached to require grad; its
backward walks the ticks in reverse, takes each microbatch's gradients with
`torch.autograd.grad`, and sends the input cotangents to the stage before
explicitly. 1F1B (`pipeline_train_step_1f1b`) is explicit throughout, as
in the JAX package.

The output comes back on every stage (the JAX package's `psum` broadcast);
the port broadcasts it from the last stage. Every stage's downstream is
then the same, so the backward takes the last stage's own cotangent, and
no copy of the others. The input cotangent, which only stage 0 computes, is
broadcast from it to every stage. Inputs and outputs are thus replicated
over the pipeline axis, with their gradients, and no gradient outside the
schedule is summed over that axis.

The same schedule can run all P stages in one process (`mesh=None`): a
hop to a stage that runs in this process is a hand-off, and the
collectives are skipped (`_Stages`). Nothing else differs, which is what
lets one card check the schedule at the width of a real model.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.collectives import gather_shards
from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
from ray_tpu_torch.parallel.sharding import tree_map


def _feasible_microbatches(B: int, requested: int) -> int:
    """Largest feasible microbatch count <= requested (the local batch
    must split evenly); warns when an EXPLICIT user value is truncated."""
    M = max(min(requested, B), 1)
    while B % M:
        M -= 1
    if M != requested:
        warnings.warn(
            f"pipeline: n_microbatches={requested} infeasible for local "
            f"batch {B}; using {M} (at M=1 the schedule degrades to "
            f"sequential stages — resize the batch for real pipelining)"
        )
    return M


def _derive_microbatches(local_batch: int, n_stages: int) -> int:
    """Default M: the largest DIVISOR of the local batch <= 4P — 4P keeps
    the GPipe bubble (P-1)/(M+P-1) near 20% without shrinking microbatches
    into slivers that starve the matmuls, and a divisor is exactly feasible
    (no truncation warning for our own derivation). The JAX package derives
    the local batch from the global one and the mesh; the port's ranks hold
    theirs."""
    return max(
        (m for m in range(1, min(4 * n_stages, local_batch) + 1) if local_batch % m == 0),
        default=1,
    )


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The leaves of nested dicts of tensors, in insertion order, and the
    function that puts a list of that length back into the same tree."""
    if not isinstance(tree, dict):
        return [tree], lambda flat: flat[0]
    keys = list(tree)
    parts = [_flatten(tree[k]) for k in keys]

    def rebuild(flat):
        out, i = {}, 0
        for k, (leaves, sub) in zip(keys, parts):
            out[k] = sub(flat[i:i + len(leaves)])
            i += len(leaves)
        return out

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def _gather_params(params, gather_dims, group):
    """All-gather the fsdp-split leaves over `group` (`gather_dims`: a
    congruent tree, read by key, of the dim per leaf or None for a leaf
    that is whole); the gather's backward reduce-scatters the gradients, so
    they land split again."""
    return tree_map(lambda p, d: p if d is None else gather_shards(p, group, d), params,
                    gather_dims)


class _Stages:
    """The stages this process runs, and how a tensor reaches another
    stage: handed over where that stage runs here too, by point-to-point
    over the pipeline group where another rank runs it. `group=None` runs
    every stage here."""

    def __init__(self, n_stages: int, group=None):
        self.n = n_stages
        self.group = group
        if group is None:
            self.local, self.ranks = list(range(n_stages)), None
        else:
            self.local, self.ranks = [dist.get_rank(group)], dist.get_process_group_ranks(group)

    def hop(self, sends: Dict[int, torch.Tensor], receivers: Sequence[int], step: int,
            like: torch.Tensor) -> Dict[int, torch.Tensor]:
        """`sends[s]` goes to stage s + step; each stage of `receivers`
        (stages of this process) gets the tensor of stage s - step, of
        `like`'s shape and type. Both ends compute which stages send, so
        every send has its receive."""
        out, ops = {}, []
        for s in receivers:
            src = s - step
            if src in self.local:
                out[s] = sends[src]
            else:
                out[s] = torch.empty_like(like)
                ops.append(dist.P2POp(dist.irecv, out[s], self.ranks[src], self.group))
        for s, t in sends.items():
            if s + step not in self.local:
                ops.append(dist.P2POp(dist.isend, t.contiguous(), self.ranks[s + step], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def from_stage(self, s: int, t: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        """Stage s's tensor `t` on every stage (None where s runs elsewhere)."""
        if self.ranks is None or self.n == 1:
            return t
        buf = t.contiguous() if s in self.local else torch.empty_like(like)
        dist.broadcast(buf, src=self.ranks[s], group=self.group)
        return buf


def _stage_params(leaves: List[torch.Tensor], stages: _Stages) -> Dict[int, List[torch.Tensor]]:
    """Per local stage, its slice of every stacked leaf, detached to
    require grad: the leaves the per-microbatch gradients are taken for."""
    return {s: [leaf[i].detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
            for i, s in enumerate(stages.local)}


def _accumulate(acc: List[Optional[torch.Tensor]], grads) -> None:
    """Add each gradient to its f32 sum (None: no gradient, leave it)."""
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g.to(torch.float32, copy=True) if acc[i] is None else acc[i].add_(g)


def _stacked_grads(acc: Dict[int, List], leaves: List[torch.Tensor], stages: _Stages,
                   scale: float = 1.0) -> List[Optional[torch.Tensor]]:
    """The per-stage sums stacked back to the leaves' shapes and types."""
    out = []
    for j, leaf in enumerate(leaves):
        if not leaf.requires_grad:
            out.append(None)
            continue
        parts = [acc[s][j] if acc[s][j] is not None
                 else torch.zeros(leaf.shape[1:], device=leaf.device) for s in stages.local]
        out.append((torch.stack(parts) * scale).to(leaf.dtype))
    return out


class _GPipe(torch.autograd.Function):
    """The GPipe schedule of the stages this process runs, forward and
    backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, fn, stages: _Stages, rebuild, M: int, record: bool, x, *leaves):
        P = stages.n
        micro = x.chunk(M)
        params = _stage_params(leaves, stages)
        graphs: Dict[int, Dict[int, tuple]] = {s: {} for s in stages.local}
        outs, recv = [None] * M, {}
        with torch.set_grad_enabled(record):  # graphs only where a backward will read them
            for t in range(M + P - 1):
                sends = {}
                for s in stages.local:
                    m = t - s  # stage s runs microbatch t - s at tick t
                    if not 0 <= m < M:
                        continue
                    inp = (micro[m] if s == 0 else recv[s]).detach().requires_grad_(
                        s > 0 or x.requires_grad)
                    y = fn(rebuild(params[s]), inp)
                    graphs[s][m] = (inp, y)
                    if s == P - 1:
                        outs[m] = y.detach()
                    else:
                        sends[s] = y.detach()
                recv = stages.hop(sends, [s for s in stages.local if s > 0 and 0 <= t - s + 1 < M],
                                  +1, micro[0])
        ctx.fn, ctx.stages, ctx.M, ctx.leaves = fn, stages, M, leaves
        ctx.graphs, ctx.params = graphs, params
        ctx.x_like = micro[0]
        ctx.x_shape, ctx.x_grad = x.shape, x.requires_grad
        last = torch.cat(outs) if P - 1 in stages.local else None
        return stages.from_stage(P - 1, last, x)

    @staticmethod
    def backward(ctx, dy):
        stages, M, P = ctx.stages, ctx.M, ctx.stages.n
        dys = dy.chunk(M)
        acc = {s: [None] * len(ctx.leaves) for s in stages.local}
        dxs, recv = [None] * M, {}
        for t in reversed(range(M + P - 1)):
            sends = {}
            for s in stages.local:
                m = t - s
                if not 0 <= m < M:
                    continue
                inp, y = ctx.graphs[s].pop(m)
                wrt = ([inp] if inp.requires_grad else []) + [
                    p for p in ctx.params[s] if p.requires_grad]
                with torch.enable_grad():
                    got = torch.autograd.grad(y, wrt, dys[m] if s == P - 1 else recv[s],
                                              allow_unused=True)
                dx, pg = (got[0], iter(got[1:])) if inp.requires_grad else (None, iter(got))
                _accumulate(acc[s], [next(pg) if p.requires_grad else None
                                     for p in ctx.params[s]])
                if s == 0:
                    dxs[m] = dx
                else:
                    sends[s] = dx
                del inp, y, got
            recv = stages.hop(sends, [s for s in stages.local if s < P - 1 and 0 <= t - s - 1 < M],
                              -1, ctx.x_like)
        dx = None
        if ctx.x_grad:
            first = torch.cat(dxs) if 0 in stages.local else None
            dx = stages.from_stage(0, first, torch.empty(ctx.x_shape, dtype=ctx.x_like.dtype,
                                                         device=ctx.x_like.device))
        grads = _stacked_grads(acc, list(ctx.leaves), stages)
        del ctx.graphs, ctx.params
        return (None, None, None, None, None, dx, *grads)


def _stages_of(stacked_params, mesh, axis: str) -> Tuple[_Stages, List[torch.Tensor], Callable]:
    leaves, rebuild = _flatten(stacked_params)
    if mesh is None:
        stages = _Stages(leaves[0].shape[0])
    else:
        stages = _Stages(mesh_axis_sizes(mesh)[axis], mesh.get_group(axis))
    for leaf in leaves:
        if leaf.shape[0] != len(stages.local):
            raise ValueError(
                f"stacked leaf of shape {tuple(leaf.shape)}: its leading dim must be the "
                f"{len(stages.local)} stage(s) this process runs"
            )
    return stages, leaves, rebuild


def pipeline_apply(
    fn: Callable,
    stacked_params,
    x: torch.Tensor,
    mesh=None,
    *,
    n_microbatches: Optional[int] = None,
    axis: str = "pipeline",
    fsdp_dims=None,
    fsdp_axis: str = "fsdp",
) -> torch.Tensor:
    """Apply `fn` (one stage's computation: fn(params, x) -> y of x's shape
    and type) as a GPipe pipeline of P stages, with gradients to the
    parameters and to `x`.

    With a `mesh`, every rank calls this with its stage's parameters (a tree
    whose leaves have a leading stage dim of 1: the layer stack split over
    `axis`, as `shard_tree` cuts it) and its batch [B_local, ...] (split
    over the batch axes, the same on every stage); it returns y
    [B_local, ...] on every stage. Without one, `stacked_params`' leaves
    have the P stages on their leading dim and every stage runs here.

    n_microbatches: None derives `_derive_microbatches(B_local, P)`.
    fsdp_dims: optional tree congruent with `stacked_params` of the dim (of
    the stacked leaf) that is split over `fsdp_axis`, or None: such leaves
    are all-gathered once per call, and their gradients reduce-scattered
    back (pp x fsdp, ZeRO-style)."""
    if fsdp_dims is not None:
        if mesh is None:
            raise ValueError("fsdp_dims needs a mesh with an fsdp axis")
        stacked_params = _gather_params(stacked_params, fsdp_dims, mesh.get_group(fsdp_axis))
    stages, leaves, rebuild = _stages_of(stacked_params, mesh, axis)
    B = x.shape[0]
    if B < 1:
        raise ValueError("pipeline stage received an empty batch")
    M = _feasible_microbatches(B, n_microbatches or _derive_microbatches(B, stages.n))
    record = torch.is_grad_enabled() and (x.requires_grad or any(l.requires_grad for l in leaves))
    return _GPipe.apply(fn, stages, rebuild, M, record, x, *leaves)


def _run_1f1b(fn, loss_fn, stages: _Stages, leaves, rebuild, micro, tgt_micro):
    """The fused forward+backward 1F1B schedule of the stages this process
    runs: (loss sum over the microbatches on the last stage or None, f32
    gradient sums per local stage).

    GPipe keeps every one of the M in-flight microbatch graphs until the
    backward starts — activation memory grows linearly with M. 1F1B starts
    each microbatch's backward as soon as the last stage finishes its
    forward, so a stage holds at most 2(P-1-s)+1 <= 2P-1 in-flight inputs
    (the ring, sized by the pipeline depth, not the microbatch count) and
    no graph across ticks: the F slot runs without autograd and the B slot
    recomputes the stage forward (remat of one stage per microbatch).
    Tick t: the F slot of stage s runs microbatch t - s, its B slot
    t - (2P - 2 - s). The last stage's B slot takes the microbatch of its
    F slot in the same tick, so its F slot only banks the input: the B
    slot's forward is the one its loss needs."""
    P, M = stages.n, len(micro)
    R = 2 * P - 1  # residual ring: max in-flight per stage
    params = _stage_params(leaves, stages)
    acc = {s: [None] * len(leaves) for s in stages.local}
    ring: Dict[int, Dict[int, torch.Tensor]] = {s: {} for s in stages.local}
    loss_sum, recv_f, recv_b = None, {}, {}
    for t in range(M + 2 * P - 2):
        sends_f, sends_b = {}, {}
        for s in stages.local:
            m_f = t - s
            if 0 <= m_f < M:
                x_in = micro[m_f] if s == 0 else recv_f[s]
                ring[s][m_f % R] = x_in  # bank the input for the backward
                if s < P - 1:
                    with torch.no_grad():
                        sends_f[s] = fn(rebuild(params[s]), x_in)
            m_b = t - (2 * P - 2 - s)
            if not 0 <= m_b < M:
                continue
            x_saved = ring[s].pop(m_b % R)
            wrt = [p for p in params[s] if p.requires_grad]
            with torch.enable_grad():
                inp = x_saved.detach().requires_grad_(s > 0)
                y = fn(rebuild(params[s]), inp)
                if s == P - 1:
                    loss = loss_fn(y, tgt_micro[m_b])
                    loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
                    got = torch.autograd.grad(loss, ([inp] if s > 0 else []) + wrt,
                                              allow_unused=True)
                else:
                    got = torch.autograd.grad(y, ([inp] if s > 0 else []) + wrt, recv_b[s],
                                              allow_unused=True)
            if s > 0:
                sends_b[s], got = got[0], got[1:]
            pg = iter(got)
            _accumulate(acc[s], [next(pg) if p.requires_grad else None for p in params[s]])
            del inp, y, got
        recv_f = stages.hop(sends_f, [s for s in stages.local if s > 0 and 0 <= t - s + 1 < M],
                            +1, micro[0])
        recv_b = stages.hop(sends_b, [s for s in stages.local
                                      if s < P - 1 and 0 <= t - (2 * P - 3 - s) < M], -1, micro[0])
    return loss_sum, acc


def pipeline_train_step_1f1b(
    fn: Callable,
    loss_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    target,
    mesh=None,
    *,
    n_microbatches: Optional[int] = None,
    axis: str = "pipeline",
    batch_axes: Sequence[str] = ("data", "fsdp"),
):
    """Fused 1F1B training step: returns (mean loss, stacked grads).

    A selectable alternative to differentiating `pipeline_apply` (GPipe):
    the same numbers, bounded activation memory (see `_run_1f1b`).
    `loss_fn(y, target) -> scalar` is the PER-MICROBATCH mean loss,
    evaluated by the last stage. Parameters, `x` and `target` [B_local, ...]
    are placed as for `pipeline_apply`. The loss comes back on every rank;
    the gradients, of the leaves' shapes and types in a tree congruent with
    `stacked_params`, are averaged over the microbatches and then over the
    ranks of the batch axes (the data-parallel reduction, as in the JAX
    package). No autograd graph is left behind."""
    stages, leaves, rebuild = _stages_of(stacked_params, mesh, axis)
    B = x.shape[0]
    M = _feasible_microbatches(B, n_microbatches or _derive_microbatches(B, stages.n))
    loss_sum, acc = _run_1f1b(fn, loss_fn, stages, leaves, rebuild, x.chunk(M), target.chunk(M))
    P = stages.n
    like = torch.zeros((), dtype=torch.float32, device=x.device)
    loss = stages.from_stage(P - 1, None if loss_sum is None else loss_sum.float() / M, like)
    grads = _stacked_grads(acc, leaves, stages, 1.0 / M)
    if mesh is not None:
        sizes = mesh_axis_sizes(mesh)
        for a in (a for a in batch_axes if sizes.get(a, 1) > 1):
            group = mesh.get_group(a)
            for t in [loss] + [g for g in grads if g is not None]:
                dist.all_reduce(t, group=group)
                t.div_(sizes[a])
    return loss, rebuild(grads)
