"""Collectives: the host `CollectiveGroup` over the runtime, and collectives
on device tensors.

The host half is the JAX package's (`ray_tpu/parallel/collectives.py:15-297`,
package name rewritten): a named coordinator actor of the runtime is the
rendezvous and the data plane of numpy arrays (control data, metric
reductions across actor groups), with `init_collective_group`,
`allreduce`, `allgather`, `reducescatter`, `broadcast`, `barrier`,
`send`/`recv` and `destroy_collective_group`; it touches no card.

The device half ports `device_allreduce` (:301-333), and adds the
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
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

import ray_tpu_torch
from ray_tpu_torch.parallel.sharding import all_gather_dim

_REDUCE_OPS = {
    "sum": lambda xs: np.sum(xs, axis=0),
    "prod": lambda xs: np.prod(xs, axis=0),
    "max": lambda xs: np.max(xs, axis=0),
    "min": lambda xs: np.min(xs, axis=0),
    "mean": lambda xs: np.mean(xs, axis=0),
}


@ray_tpu_torch.remote(num_cpus=0)
class _GroupCoordinator:
    """Named rendezvous actor holding per-collective state.

    Plays the role of the reference's NCCLUniqueID store actor
    (python/ray/util/collective/collective.py:40 GroupManager) — but since XLA
    needs no communicator handshake, it doubles as the data plane for host
    arrays (fine for control-sized payloads; tensor traffic is ICI-compiled).

    All waits are ASYNC parks on the actor's event loop (one RPC per rank
    per collective, zero polling): the last contributor sets the round's
    asyncio.Event and every parked rank resumes — the blocking analogue of
    the reference's gloo rendezvous, built on the runtime's async actors.
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._rounds: Dict[str, Dict[int, Any]] = {}
        self._done: Dict[str, Any] = {}
        self._collected: Dict[str, set] = {}
        self._events: Dict[str, Any] = {}
        # p2p keys whose receiver timed out and left: a LATE put for one
        # of these is dropped instead of stranding the payload forever
        # (p2p seqs are never reused).  Bounded: entries clear on the
        # matching put; a dead sender leaves only the key string.
        self._abandoned: "set[str]" = set()

    def _event(self, key: str):
        import asyncio

        ev = self._events.get(key)
        if ev is None:
            ev = self._events[key] = asyncio.Event()
        return ev

    async def exchange(self, key: str, rank: int, value, timeout: float):
        """Contribute this rank's value and WAIT (parked, not polling)
        until every rank has; returns the full {rank: value} round."""
        import asyncio

        round_ = self._rounds.setdefault(key, {})
        round_[rank] = value
        ev = self._event(key)
        if len(round_) == self.world_size:
            self._done[key] = dict(round_)
            del self._rounds[key]
            ev.set()
        else:
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                if key not in self._done:
                    # True timeout: withdraw this rank's contribution so a
                    # retried round sees no ghost participant, and free the
                    # round's state once the last waiter leaves — timed-out
                    # keys are never reused (seq-suffixed) and would leak.
                    round_ = self._rounds.get(key)
                    if round_ is not None:
                        round_.pop(rank, None)
                        if not round_:
                            del self._rounds[key]
                            self._events.pop(key, None)
                    return None
                # Lost the race: the round completed as the timer fired —
                # collect normally (skipping would strand _done forever).
        out = self._done.get(key)
        # Free the round once every rank has fetched it, so a long-running
        # loop of collectives doesn't grow the coordinator without bound.
        seen = self._collected.setdefault(key, set())
        seen.add(rank)
        if len(seen) == self.world_size:
            self._done.pop(key, None)
            self._collected.pop(key, None)
            self._events.pop(key, None)
        return out

    async def p2p_put(self, key: str, value):
        if key in self._abandoned:
            self._abandoned.discard(key)
            self._events.pop(key, None)
            return  # receiver already gave up on this seq: drop, don't strand
        self._done[key] = value
        self._event(key).set()

    async def p2p_take(self, key: str, timeout: float):
        import asyncio

        ev = self._event(key)
        if key not in self._done:
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                if key not in self._done:
                    # True timeout (not the completion-vs-timer race —
                    # that falls through and drains normally).
                    self._events.pop(key, None)
                    self._abandoned.add(key)
                    return None
        self._events.pop(key, None)
        return self._done.pop(key, None)


class CollectiveGroup:
    """One rank's view of a host collective group.

    timeout_s bounds every collective: if a peer rank dies before
    contributing, the others raise instead of waiting forever (the
    reference's collective ops error out on dead peers).  Waits park on
    the coordinator's event loop — one RPC per rank per collective, no
    client-side polling.
    """

    def __init__(self, name: str, world_size: int, rank: int, timeout_s: float = 120.0):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.timeout_s = timeout_s
        self._seq = 0
        self._p2p_seq: Dict[tuple, int] = {}  # (src, dst) -> next seq
        self._coord = _get_or_create_coordinator(name, world_size)

    def _timeout_error(self, what: str) -> RuntimeError:
        return RuntimeError(
            f"collective {what} timed out after {self.timeout_s}s in group "
            f"{self.name!r} (rank {self.rank}/{self.world_size}) — a peer "
            "rank likely died before contributing"
        )

    # -- collectives ------------------------------------------------------
    def _exchange(self, tag: str, value) -> Dict[int, Any]:
        self._seq += 1
        key = f"{tag}:{self._seq}"
        out = ray_tpu_torch.get(
            self._coord.exchange.remote(key, self.rank, value, self.timeout_s),
            timeout=self.timeout_s + 30,
        )
        if out is None:
            raise self._timeout_error(key)
        return out

    def allreduce(self, arr, op: str = "sum"):
        parts = self._exchange("ar", np.asarray(arr))
        return _REDUCE_OPS[op]([parts[r] for r in sorted(parts)])

    def allgather(self, arr) -> List[np.ndarray]:
        parts = self._exchange("ag", np.asarray(arr))
        return [parts[r] for r in sorted(parts)]

    def reducescatter(self, arr, op: str = "sum"):
        reduced = self.allreduce(arr, op)
        return np.array_split(reduced, self.world_size)[self.rank]

    def broadcast(self, arr, src_rank: int = 0):
        parts = self._exchange("bc", np.asarray(arr) if self.rank == src_rank else None)
        return parts[src_rank]

    def barrier(self):
        self._exchange("bar", None)

    def _p2p_key(self, src: int, dst: int) -> str:
        # Sequence numbers are per (src, dst) channel: a shared counter would
        # desynchronize keys under any asymmetric send/recv pattern.
        seq = self._p2p_seq.get((src, dst), 0)
        self._p2p_seq[(src, dst)] = seq + 1
        return f"p2p:{src}->{dst}:{seq}"

    def send(self, arr, dst_rank: int):
        key = self._p2p_key(self.rank, dst_rank)
        ray_tpu_torch.get(self._coord.p2p_put.remote(key, np.asarray(arr)))

    def recv(self, src_rank: int):
        key = self._p2p_key(src_rank, self.rank)
        out = ray_tpu_torch.get(
            self._coord.p2p_take.remote(key, self.timeout_s),
            timeout=self.timeout_s + 30,
        )
        if out is None:
            raise self._timeout_error(key)
        return out


_registry: Dict[str, "CollectiveGroup"] = {}
_groups_lock = threading.Lock()


def _get_or_create_coordinator(name: str, world_size: int):
    """Racy rendezvous: every rank tries get-then-create; exactly one create
    wins the name registration, losers fall back to get (mirrors the
    reference's named-actor NCCL-ID rendezvous, collective.py:40)."""
    import time

    actor_name = f"_collective_coord:{name}"
    deadline = time.monotonic() + 30
    while True:
        try:
            return ray_tpu_torch.get_actor(actor_name)
        except Exception:
            pass
        try:
            return _GroupCoordinator.options(name=actor_name).remote(world_size)
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)


def init_collective_group(
    world_size: int, rank: int, backend: str = "xla", group_name: str = "default"
) -> CollectiveGroup:
    """ray: util/collective/collective.py:120. backend is accepted for API
    parity; host groups always run over the actor runtime ("gloo" analogue),
    device collectives are always compiled XLA."""
    group = CollectiveGroup(group_name, world_size, rank)
    _groups()[group_name] = group
    return group


def _groups() -> Dict[str, CollectiveGroup]:
    return _registry


def get_group(group_name: str = "default") -> CollectiveGroup:
    try:
        return _groups()[group_name]
    except KeyError:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this process"
        )


def allreduce(arr, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(arr, op)


def allgather(arr, group_name: str = "default"):
    return get_group(group_name).allgather(arr)


def reducescatter(arr, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(arr, op)


def broadcast(arr, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(arr, src_rank)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()


def send(arr, dst_rank: int, group_name: str = "default"):
    get_group(group_name).send(arr, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return get_group(group_name).recv(src_rank)


def destroy_collective_group(group_name: str = "default"):
    _groups().pop(group_name, None)


# -- device collectives ------------------------------------------------------


_DIST_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
             "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def device_allreduce(x: torch.Tensor, mesh, axis: str = "data", op: str = "sum") -> torch.Tensor:
    """All-reduce of this rank's `x` over the mesh axis `axis`: a new tensor
    with the sum, mean, max or min over the ranks of the axis (every rank of
    the mesh calls it). The JAX package's version reduces the shards of one
    global array, which is what each rank's `x` is here."""
    try:
        reduce_op = _DIST_OPS[op]
    except KeyError:
        raise ValueError(f"unknown op {op!r}; options {sorted(_DIST_OPS)}")
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
