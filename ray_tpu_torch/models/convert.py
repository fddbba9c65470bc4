"""Carry weights over from the JAX package's parameter tree, and start a
training state from them; carry an RL learner's state over whole."""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ray_tpu_torch.models.lm import _new_state, default_optimizer
from ray_tpu_torch.models.transformer import param_axes
from ray_tpu_torch.parallel.sharding import Rules, resolve_rules, shard_tree


def params_from_numpy(
    tree: Dict[str, Any],
    *,
    device,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """The JAX `init_params` tree with every leaf a numpy array -> the port's
    parameters: the same names and shapes, no transposes, on `device`. Leaves
    keep their type unless `dtype` is given (a server may pass the compute
    dtype to cast once at load). A bf16 leaf comes over bit for bit."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device=device, dtype=dtype)
            continue
        t = _tensor(np.asarray(leaf), device)
        out[name] = t if dtype is None else t.to(dtype)
    return out


def _tensor(leaf: np.ndarray, device) -> torch.Tensor:
    """A copy of `leaf` on `device`. numpy has no bf16 of its own: the JAX
    package's bf16 leaves are `ml_dtypes.bfloat16`, which torch cannot read,
    so their bits are read as int16 and viewed as torch.bfloat16, with no
    rounding on the way."""
    if leaf.dtype.name == "bfloat16":
        bits = torch.tensor(leaf.view(np.int16), device=device)  # copies
        return bits.view(torch.bfloat16)
    return torch.tensor(leaf, device=device)  # copies


def state_from_numpy(
    params_tree: Dict[str, Any],
    config,
    optimizer=None,
    *,
    device,
    mesh=None,
    strategy: Union[str, Rules] = "dp",
) -> Dict[str, Any]:
    """A step-0 training state for `LMTrainContext.train_step` from the JAX
    `init_params` tree (numpy leaves): the parameters in
    `config.param_dtype` on `device`, and zero optimizer moments (those of
    `optimizer`, by default `default_optimizer()`). With a `mesh`, every
    rank passes the same full tree and keeps its shards of it under
    `strategy`'s rules, as `LMTrainContext(config, mesh, strategy)` holds
    its state."""
    params = params_from_numpy(params_tree, device=device, dtype=config.param_dtype)
    if mesh is not None:
        params = shard_tree(params, param_axes(config), resolve_rules(strategy), mesh)
    return _new_state(params, optimizer or default_optimizer())


# The leaves of an RL learner's state that its update differentiates.
_TRAINABLE = ("params", "log_alpha")


def learner_state_from_numpy(state: Dict[str, Any], *, device) -> Dict[str, Any]:
    """A JAX RL learner's state (`init_state` or an update's output of the
    JAX package's `rllib` learners, every leaf a numpy array, as
    `jax.tree_util.tree_map(np.asarray, state)` gives it) -> the port's
    learner state on `device`, the same tree:

    - "params" and "log_alpha" become tensors that require grad, every
      other array ("target", ...) a plain tensor;
    - an optax Adam state (optax.adam's chain, a tuple holding a
      ScaleByAdamState) becomes {"count": int, "mu", "nu"}, the moments'
      trees as the port's `adam` keeps them;
    - the PRNG "key" becomes "rng", a torch.Generator on `device` seeded
      with 0: jax.random cannot be reproduced.
    """
    out = {}
    for k, v in state.items():
        adam_state = _adam_state(v)
        if k == "key":
            out["rng"] = torch.Generator(device=device).manual_seed(0)
        elif adam_state is not None:
            out[k] = {"count": int(adam_state.count),
                      "mu": _tensors(adam_state.mu, device, False),
                      "nu": _tensors(adam_state.nu, device, False)}
        else:
            out[k] = _tensors(v, device, k in _TRAINABLE)
    return out


def _adam_state(v):
    """optax's ScaleByAdamState: `v` itself, or the member of optax.adam's
    chain tuple that holds it; else None."""
    for x in (v, *(v if isinstance(v, tuple) else ())):
        if all(hasattr(x, f) for f in ("count", "mu", "nu")):
            return x
    return None


def _tensors(tree, device, requires_grad: bool):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, requires_grad) for v in tree]
    return _tensor(np.asarray(tree), device).requires_grad_(requires_grad)
