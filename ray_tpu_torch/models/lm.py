"""Language-model training step, port of `ray_tpu/models/lm.py` on one
device: the loss, the default optimizer and `LMTrainContext`.

The JAX package's step is a jitted pure function whose state is donated; the
port runs eagerly and updates the parameters and the optimizer's moments in
place, which is what donation lets XLA do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _leaves,
    _resolve_device,
    forward,
    init_params,
)


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
    `init(params) -> opt_state` and `update(grads, opt_state, params) ->
    opt_state`, which changes `params` and the state's moments in place."""

    init: Callable[[List[torch.Tensor]], Dict]
    update: Callable[[List[torch.Tensor], Dict, List[torch.Tensor]], Dict]


def default_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1) -> Optimizer:
    """optax.chain(clip_by_global_norm(1.0), adamw(learning_rate, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay)), in optax's order. Weight decay applies
    to every leaf, norms too (optax gets no mask here); the moments are kept
    in the params' dtype, as optax keeps them."""
    b1, b2, eps, max_norm = 0.9, 0.95, 1e-8, 1.0

    def init(params: List[torch.Tensor]) -> Dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, requires_grad=False) for p in params],
            "nu": [torch.zeros_like(p, requires_grad=False) for p in params],
        }

    @torch.no_grad()
    def update(grads: List[torch.Tensor], opt_state: Dict, params: List[torch.Tensor]) -> Dict:
        grads = list(grads)
        # clip_by_global_norm: g * (max_norm / max(|g|, max_norm)), in place.
        torch._foreach_mul_(grads, max_norm / torch.clamp(_global_norm(grads), min=max_norm))
        # scale_by_adam, with bias correction at count + 1.
        count = opt_state["count"] + 1
        mu, nu = opt_state["mu"], opt_state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        upd = torch._foreach_div(mu, 1 - b1 ** count)
        denom = torch._foreach_div(nu, 1 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(upd, denom)
        # add_decayed_weights, then scale_by_learning_rate and apply_updates.
        torch._foreach_add_(upd, params, alpha=weight_decay)
        torch._foreach_add_(params, upd, alpha=-learning_rate)
        return {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _new_state(params: Dict, optimizer: Optimizer) -> Dict[str, Any]:
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(leaves), "step": 0}


class LMTrainContext:
    """Init/train-step bundle for one config on one device: the port of the
    JAX package's `LMTrainContext` with strategy "dp" on a one-device mesh.

    Runs on the CUDA card unless `device` names another (the tests pass
    "cpu"); with no card and no device it raises."""

    def __init__(
        self,
        config: TransformerConfig,
        mesh=None,
        *,
        strategy: str = "dp",
        optimizer: Optional[Optimizer] = None,
        device=None,
    ):
        if mesh is not None or strategy != "dp":
            raise NotImplementedError(
                f"strategy {strategy!r} and meshes come with the multi-device slice of "
                "the port (ROADMAP A5); this slice trains with 'dp' on one device"
            )
        self.config = config
        self.device = _resolve_device(device)
        self.optimizer = optimizer or default_optimizer()

    # -- public API -------------------------------------------------------
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return _new_state(init_params(self.config, gen, device=self.device), self.optimizer)

    def make_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch (dict of [B, S] numpy arrays or tensors) on the
        device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def train_step(self, state, batch) -> Tuple[Dict, Dict]:
        """One step of loss, gradients, clipping and AdamW. Updates
        `state`'s tensors in place and returns (state, metrics) with metrics
        `loss`, `grad_norm` (before clipping) and `step`; the metrics stay on
        the device until read."""
        batch = self.make_batch(batch)
        params = state["params"]
        leaves = _leaves(params)
        logits = forward(params, batch["tokens"], self.config)
        loss = cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
        del logits
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = _global_norm(list(grads))
        opt_state = self.optimizer.update(grads, state["opt_state"], leaves)
        step = state["step"] + 1
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "step": step}
        return {"params": params, "opt_state": opt_state, "step": step}, metrics

    def apply(self, params, tokens) -> torch.Tensor:
        with torch.no_grad():
            return forward(params, torch.as_tensor(tokens, device=self.device), self.config)
