"""TorchPolicy: the actor-critic network and its batch inference, port of
`ray_tpu/rllib/policy.py`.

ray: rllib/policy/torch_policy_v2.py + core/rl_module/rl_module.py. The
parameters are a tree of tensors with the JAX package's names and [in, out]
layout, so a JAX tree carries over with no transposes; inference is one
batch call on the device (`compute_actions`); the learners differentiate
plain loss functions of the tree with autograd.

`jax.random` cannot be reproduced: the orthogonal init draws from a
`torch.Generator` and is the JAX package's in distribution, not in value.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.transformer import _resolve_device
from ray_tpu_torch.parallel.sharding import tree_map


def orthogonal(generator: torch.Generator, shape: Tuple[int, int], scale: float) -> torch.Tensor:
    """jax.nn.initializers.orthogonal(scale) for an [in, out] matrix, f32 on
    the generator's device: the QR of a normal draw, signs fixed by R's
    diagonal, so that the columns (the rows where in < out) are orthonormal,
    times `scale`."""
    w = torch.empty(shape, device=generator.device)
    with torch.no_grad():
        return torch.nn.init.orthogonal_(w, scale, generator=generator)


def init_policy_params(
    generator: torch.Generator, obs_size: int, num_actions: int,
    hidden: Tuple[int, ...] = (64, 64),
) -> Dict[str, Any]:
    """MLP torso + separate policy/value heads (orthogonal init — the PPO
    baseline choice), on the generator's device."""
    dev = generator.device
    sizes = (obs_size,) + tuple(hidden)
    params = {"torso": [], "pi": None, "vf": None}
    for i in range(len(hidden)):
        params["torso"].append({
            "w": orthogonal(generator, (sizes[i], sizes[i + 1]), 2.0 ** 0.5),
            "b": torch.zeros(sizes[i + 1], device=dev),
        })
    params["pi"] = {"w": orthogonal(generator, (sizes[-1], num_actions), 0.01),
                    "b": torch.zeros(num_actions, device=dev)}
    params["vf"] = {"w": orthogonal(generator, (sizes[-1], 1), 1.0),
                    "b": torch.zeros(1, device=dev)}
    return params


def apply_policy(params: Dict[str, Any], obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, obs_size] → (logits [B, A], value [B])."""
    h = obs
    for layer in params["torso"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def categorical(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of a categorical over the last axis of `logits`, as
    jax.random.categorical draws it: the argmax of the logits plus Gumbel
    noise, -log(-log(u)) with u uniform in [tiny, 1)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_actions(forward, params, obs: torch.Tensor, generator: torch.Generator):
    """(actions [B] int64, their log-probs [B], values [B]) of one batch."""
    logits, value = forward(params, obs)
    action = categorical(generator, logits)
    logp = torch.log_softmax(logits, dim=-1)
    return action, logp.gather(1, action[:, None])[:, 0], value


def to_numpy(tree):
    """A host copy of a tree of tensors: numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


class TorchPolicy:
    """Stateful convenience wrapper used by env runners: params + generator,
    on the card unless `device` names another (with no card and no device it
    raises).

    `module` plugs a custom RLModule architecture in (ray: rl_module.py);
    None keeps the built-in MLP."""

    def __init__(self, obs_size: int, num_actions: int, seed: int = 0,
                 hidden=(64, 64), module=None, *, device=None):
        self.obs_size = obs_size
        self.num_actions = num_actions
        self.module = module
        self.device = _resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if module is None:
            self.params = init_policy_params(self.generator, obs_size, num_actions, hidden)
            self._forward = apply_policy
        else:
            self.params = module.init(self.generator, obs_size, num_actions)
            self._forward = module.forward

    @torch.no_grad()
    def set_weights(self, params) -> None:
        """Copy a congruent tree (numpy arrays or tensors on any device) into
        the policy's own parameters."""
        tree_map(lambda p, w: p.copy_(torch.as_tensor(w)), self.params, params)

    def get_weights(self):
        return to_numpy(self.params)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray):
        """Batch inference: [N, obs] → (actions [N], logp [N], values [N])."""
        obs_t = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        a, lp, v = sample_actions(self._forward, self.params, obs_t, self.generator)
        return a.cpu().numpy(), lp.cpu().numpy(), v.cpu().numpy()
