"""Carry weights over from the JAX package's parameter tree, and start a
training state from them."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.lm import _new_state, default_optimizer


def params_from_numpy(
    tree: Dict[str, Any],
    *,
    device,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """The JAX `init_params` tree with every leaf a numpy array -> the port's
    parameters: the same names and shapes, no transposes, on `device`. Leaves
    keep their type unless `dtype` is given (a server may pass the compute
    dtype to cast once at load)."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device=device, dtype=dtype)
            continue
        t = torch.tensor(np.asarray(leaf), device=device)  # copies
        out[name] = t if dtype is None else t.to(dtype)
    return out


def state_from_numpy(
    params_tree: Dict[str, Any],
    config,
    optimizer=None,
    *,
    device,
) -> Dict[str, Any]:
    """A step-0 training state for `LMTrainContext.train_step` from the JAX
    `init_params` tree (numpy leaves): the parameters in
    `config.param_dtype` on `device`, and zero optimizer moments (those of
    `optimizer`, by default `default_optimizer()`)."""
    params = params_from_numpy(params_tree, device=device, dtype=config.param_dtype)
    return _new_state(params, optimizer or default_optimizer())
