"""Language-model training step, port of `ray_tpu/models/lm.py`: the loss,
the default optimizer and `LMTrainContext`, on one device or sharded over a
mesh by a strategy's rules.

The JAX package's step is a jitted pure function whose state is donated; the
port runs eagerly and updates the parameters and the optimizer's moments in
place, which is what donation lets XLA do. Under a mesh each rank holds its
shards of the state and steps on its slice of the batch; the collectives
that XLA derives from the shardings are issued by the forward
(`models/transformer.py`) and by the step (the loss's token count, the
gradients' sums, the gradient norm).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _as_axes,
    _resolve_device,
    _sharded,
    forward,
    init_params,
    param_axes,
)
from ray_tpu_torch.ops.cuda import adamw
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_axis_sizes
from ray_tpu_torch.parallel.sharding import (
    Rules,
    gather_tensor,
    resolve_rules,
    shard_tensor,
    shard_tree,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.util import tracing


def cross_entropy_loss(
    logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean next-token cross entropy. logits [B,S,V] f32, targets [B,S]."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.to(torch.float32)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer(NamedTuple):
    """The port's form of an optax GradientTransformation whose updates are
    applied in place, on lists of tensors (a parameter tree's leaves):
    `init(params) -> opt_state` and `update(grads, opt_state, params,
    grad_norm=None) -> opt_state`, which changes `params` and the state's
    moments in place. `grad_norm` is the gradients' global norm where the
    caller has it, and must be given where the leaves are shards."""

    init: Callable[[List[torch.Tensor]], Dict]
    update: Callable[[List[torch.Tensor], Dict, List[torch.Tensor]], Dict]


def default_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1) -> Optimizer:
    """optax.chain(clip_by_global_norm(1.0), adamw(learning_rate, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay)), in optax's order. Weight decay applies
    to every leaf, norms too (optax gets no mask here); the moments are kept
    in the params' dtype, as optax keeps them, as lists in the leaves' order.

    CUDA leaves take one kernel launch each after the global norm
    (`ops/cuda/adamw.py:clip_adamw`), which raises on a leaf it cannot take;
    other leaves take the plain chain (`_clip_adamw_plain`)."""
    hyper = dict(learning_rate=learning_rate, weight_decay=weight_decay, b1=0.9, b2=0.95,
                 eps=1e-8, max_norm=1.0)

    def init(params: List[torch.Tensor]) -> Dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, requires_grad=False) for p in params],
            "nu": [torch.zeros_like(p, requires_grad=False) for p in params],
        }

    @torch.no_grad()
    def update(grads: List[torch.Tensor], opt_state: Dict, params: List[torch.Tensor],
               grad_norm: Optional[torch.Tensor] = None) -> Dict:
        grads = list(grads)
        if grad_norm is None:
            grad_norm = _global_norm(grads)
        count = opt_state["count"] + 1
        mu, nu = opt_state["mu"], opt_state["nu"]
        if any(p.device.type == "cuda" for p in params):
            adamw.clip_adamw(grads, mu, nu, params, grad_norm, count, **hyper)
        else:
            _clip_adamw_plain(grads, mu, nu, params, grad_norm, count, **hyper)
        return {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _clip_adamw_plain(grads: List[torch.Tensor], mu: List[torch.Tensor], nu: List[torch.Tensor],
                      params: List[torch.Tensor], grad_norm: torch.Tensor, count: int, *,
                      learning_rate: float, weight_decay: float, b1: float, b2: float,
                      eps: float, max_norm: float) -> None:
    """clip_by_global_norm(max_norm) then adamw as a chain of `_foreach`
    passes, on any device: the plain version of `ops/cuda/adamw.py`'s kernel,
    with the same arguments. Clips `grads` in place and updates the moments
    and `params` in place; `count` is the step count after this update."""
    # clip_by_global_norm: g * (max_norm / max(|g|, max_norm)), in place.
    torch._foreach_mul_(grads, max_norm / torch.clamp(grad_norm, min=max_norm))
    upd = _scale_by_adam(grads, mu, nu, count, b1, b2, eps)
    # add_decayed_weights, then scale_by_learning_rate and apply_updates.
    torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-learning_rate)


def _scale_by_adam(grads: List[torch.Tensor], mu: List[torch.Tensor], nu: List[torch.Tensor],
                   count: int, b1: float, b2: float, eps: float) -> List[torch.Tensor]:
    """optax.scale_by_adam on lists of tensors: the moments updated in place,
    and the updates mu_hat / (sqrt(nu_hat) + eps) returned, with the bias
    correction at `count`, the count after this step."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    upd = torch._foreach_div(mu, 1 - b1 ** count)
    denom = torch._foreach_div(nu, 1 - b2 ** count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(upd, denom)
    return upd


def adam(learning_rate: float) -> Optimizer:
    """optax.adam(learning_rate) with its default b1, b2 and eps, as the RL
    learners call it, on a tree of parameters (nested dicts and lists, or
    one tensor): `init(params)` gives {"count": 0, "mu", "nu"}, the moments
    trees congruent with `params` in the params' dtype; `update(grads,
    opt_state, params)` takes the gradients in the params' leaf order
    (`tree_leaves`) and updates the parameters and the moments in place."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(params) -> Dict:
        def zeros(p):
            return torch.zeros_like(p, requires_grad=False)

        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, opt_state: Dict, params) -> Dict:
        count = opt_state["count"] + 1
        upd = _scale_by_adam(list(grads), tree_leaves(opt_state["mu"]),
                             tree_leaves(opt_state["nu"]), count, b1, b2, eps)
        torch._foreach_add_(tree_leaves(params), upd, alpha=-learning_rate)
        return {**opt_state, "count": count}

    return Optimizer(init, update)


def _new_state(params: Dict, optimizer: Optimizer) -> Dict[str, Any]:
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(leaves), "step": 0}


class LMTrainContext:
    """Init/train-step bundle for one (config, mesh, strategy), the port of
    the JAX package's `LMTrainContext`.

    Without a mesh the step runs on one device: the card unless `device`
    names another (the tests pass "cpu"); with no card and no device it
    raises. With a mesh (`build_mesh`, a DeviceMesh of the canonical axes)
    every rank of it builds one context and calls each method in step: the
    state holds the rank's shards (`shard_tree` by the strategy's rules),
    the optimizer's moments mirror them, and the device is the mesh's.

    `strategy` is a preset name or a rules table, every preset of the JAX
    package. The default is "fsdp", as the JAX package's is: without a mesh
    it is the same step as "dp", as are "pp" and "pp_fsdp", which pipeline
    the layer stack only over a `pipeline` axis of size > 1.
    Pipelined, every stage computes the same loss from the logits the
    schedule broadcasts, and the gradients of the leaves outside the stack
    (embedding, final norm, head) come out whole on every stage, so none is
    summed over the pipeline axis (`parallel/pipeline.py`).
    """

    def __init__(
        self,
        config: TransformerConfig,
        mesh: Optional[DeviceMesh] = None,
        strategy: Union[str, Rules] = "fsdp",
        optimizer: Optional[Optimizer] = None,
        *,
        device=None,
    ):
        self.config = config
        self.strategy = strategy if isinstance(strategy, str) else "rules"
        self.rules = resolve_rules(strategy)
        self.optimizer = optimizer or default_optimizer()
        self.mesh = mesh
        if mesh is None:
            self.device = _resolve_device(device)
            return
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh (build_mesh), got {type(mesh)}")
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        if device is not None and torch.device(device).type != self.device.type:
            raise ValueError(f"device {device!r} is not the mesh's ({mesh.device_type})")
        sizes = mesh_axis_sizes(mesh)
        # The mesh axes that split the batch and the sequence (each must
        # divide), and those that split each parameter leaf.
        self._batch_place = tuple(
            tuple(a for a in _as_axes(self.rules.get(name)) if sizes[a] > 1)
            for name in ("act_batch", "act_seq")
        )
        self.batch_axes = _in_order(a for axes in self._batch_place for a in axes)
        # The forward's plan of this (config, rules, mesh), built here once.
        self.placements = _sharded(config, self.rules, mesh).places

    # -- public API -------------------------------------------------------
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """The full tree from a seeded generator, the same on every rank,
        then this rank's shards of it, and zero moments of their shape."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_params(self.config, gen, device=self.device)
        if self.mesh is not None:
            params = shard_tree(params, param_axes(self.config), self.rules, self.mesh)
        return _new_state(params, self.optimizer)

    def make_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch (dict of [B, S] numpy arrays or tensors) on the
        device. Under a mesh every rank passes the same global batch and
        keeps its slice: B over act_batch's mesh axes, S over act_seq's, as
        the JAX package's `make_batch` places the shards."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.mesh is not None:
                t = shard_tensor(t, self._batch_place, self.mesh)
            out[k] = t.to(self.device)
        return out

    def train_step(self, state, batch) -> Tuple[Dict, Dict]:
        """One step of loss, gradients, clipping and AdamW. Updates
        `state`'s tensors in place and returns (state, metrics) with metrics
        `loss`, `grad_norm` (before clipping) and `step`, global and the
        same on every rank; the metrics stay on the device until read.
        `batch` is the global batch, as `make_batch` takes it.

        With tracing on (`util/tracing.py`) the step is the span
        `lm::train_step` (attrs `step`, `tokens` of the global batch,
        `strategy`), its phases the child spans `lm::forward`, `lm::loss`,
        `lm::backward` (remat's recompute included), `lm::grad_norm` (under
        a mesh also the gradients' and the loss's sums) and `lm::optimizer`.
        They time the host's launches of each phase, so a device trace read
        with them credits each kernel to the phase that launched it."""
        attrs = None
        if tracing.is_enabled():
            attrs = {"step": state["step"], "tokens": torch.as_tensor(batch["tokens"]).numel(),
                     "strategy": self.strategy}
        with tracing.span("lm::train_step", attrs=attrs):
            batch = self.make_batch(batch)
            params = state["params"]
            leaves = tree_leaves(params)
            with tracing.span("lm::forward"):
                logits = forward(params, batch["tokens"], self.config,
                                 rules=None if self.mesh is None else self.rules, mesh=self.mesh)
            with tracing.span("lm::loss"):
                if self.mesh is None:
                    loss = cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
                else:
                    loss = self._rank_loss(logits, batch)
                del logits
            with tracing.span("lm::backward"):
                grads = torch.autograd.grad(loss, leaves)
            with tracing.span("lm::grad_norm"):
                if self.mesh is None:
                    grad_norm = _global_norm(list(grads))
                else:
                    grad_norm = self._reduce_grads(grads, params)
                    loss = self._sum_over(loss.detach(), self.batch_axes)
            with tracing.span("lm::optimizer"):
                opt_state = self.optimizer.update(grads, state["opt_state"], leaves, grad_norm)
        step = state["step"] + 1
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "step": step}
        return {"params": params, "opt_state": opt_state, "step": step}, metrics

    def state_placements(self) -> Dict[str, Any]:
        """The placements of the state's tensors under the mesh, for a
        sharded checkpoint (`air.Checkpoint.from_torch_state_sharded`, and
        `get_torch_state` to restore under this context's strategy): the
        parameters', and the optimizer moments', which are lists in the
        parameters' leaf order."""
        if self.mesh is None:
            raise ValueError("a context without a mesh holds its state whole")
        leaves = tree_leaves(self.placements)
        return {"params": self.placements, "opt_state": {"mu": list(leaves), "nu": list(leaves)}}

    def apply(self, params, tokens) -> torch.Tensor:
        """Logits [B, S, vocab] f32 of a global [B, S] batch of tokens; under
        a mesh every rank passes the same tokens and gets all the logits."""
        with torch.no_grad():
            if self.mesh is None:
                return forward(params, torch.as_tensor(tokens, device=self.device), self.config)
            local = self.make_batch({"tokens": tokens})["tokens"]
            logits = forward(params, local, self.config, rules=self.rules, mesh=self.mesh)
            return gather_tensor(logits, self._batch_place + ((),), self.mesh)

    # -- the step's collectives -------------------------------------------
    def _sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        """`x` summed over the ranks of the mesh axes `axes`, in place."""
        for a in axes:
            dist.all_reduce(x, group=self.mesh.get_group(a))
        return x

    def _rank_loss(self, logits: torch.Tensor, batch) -> torch.Tensor:
        """This rank's share of the global masked mean: its tokens' summed
        loss over the token count of the whole batch, so that the ranks'
        shares, and their gradients, sum to the global loss's."""
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, batch["targets"][..., None].long())[..., 0]
        mask = batch.get("mask")
        if mask is None:
            total = -ll.sum()
            count = torch.full((), float(ll.numel()), device=ll.device)  # no host copy
        else:
            mask = mask.to(torch.float32)
            total = -(ll * mask).sum()
            count = mask.sum().detach()
        count = self._sum_over(count, self.batch_axes)
        return total / torch.clamp(count, min=1.0)

    def _reduce_grads(self, grads, params) -> torch.Tensor:
        """Sum each gradient of the leaves of `params`, in place, over the
        batch axes that do not split its leaf (fsdp's gather already summed
        over its axis; over `tensor` the gradient is never summed), and
        return the global norm: each leaf's squares summed over the axes
        that split it."""
        places = tree_leaves(tree_map(lambda _, place: place, params, self.placements))
        squares: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, place in zip(grads, places):
            axes = _in_order(a for split in place for a in split)
            self._sum_over(g, [a for a in self.batch_axes if a not in axes])
            sq = torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
            squares[axes] = squares[axes] + sq if axes in squares else sq
        total = sum(self._sum_over(sq, axes) for axes, sq in sorted(squares.items()))
        return torch.sqrt(total)


def _in_order(axes) -> Tuple[str, ...]:
    """Mesh axes, each once, in the mesh's order (every rank issues the
    collectives over them in the same order)."""
    axes = set(axes)
    return tuple(a for a in AXIS_ORDER if a in axes)
