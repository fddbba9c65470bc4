"""RLModule: the pluggable model abstraction, port of
`ray_tpu/rllib/rl_module.py`.

ray: rllib/core/rl_module/rl_module.py — a module is a pair of plain
functions, `init(generator, obs_size, num_actions) -> params` (a tree of
tensors on the generator's device) and `forward(params, obs) -> (logits,
value)`, so the learners differentiate straight through it; no wrapper
object holds state. Modules must pickle (they ride to env runners).

Built-ins:
  * MLPModule        — tanh MLP torso + categorical policy / value heads
                       (the default every algorithm uses);
  * ContinuousMLPModule — squashed-Gaussian policy + twin Q heads (SAC).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ray_tpu_torch.rllib.policy import apply_policy, init_policy_params, orthogonal


class RLModule:
    """Interface (ray: rl_module.py RLModule): subclass and override
    init/forward to plug a custom architecture into PPO/IMPALA/APPO
    via config.rl_module(module=...)."""

    def init(self, generator: torch.Generator, obs_size: int, num_actions: int) -> Dict[str, Any]:
        raise NotImplementedError

    def forward(self, params: Dict[str, Any], obs):
        """obs [B, obs_size] -> (logits [B, A], value [B])."""
        raise NotImplementedError


class MLPModule(RLModule):
    """Default actor-critic MLP (orthogonal init, tanh activations)."""

    def __init__(self, hidden: Tuple[int, ...] = (64, 64)):
        self.hidden = tuple(hidden)

    def init(self, generator, obs_size: int, num_actions: int) -> Dict[str, Any]:
        return init_policy_params(generator, obs_size, num_actions, self.hidden)

    def forward(self, params: Dict[str, Any], obs):
        return apply_policy(params, obs)


class ContinuousMLPModule(RLModule):
    """Squashed-Gaussian actor + twin Q critics for continuous control
    (SAC — ray: rllib/algorithms/sac's policy/Q model pair)."""

    def __init__(self, hidden: Tuple[int, ...] = (128, 128)):
        self.hidden = tuple(hidden)

    @staticmethod
    def _mlp_init(generator, sizes, out, out_scale=1.0):
        dims = tuple(sizes) + (out,)
        layers = []
        for i in range(len(dims) - 1):
            scale = 2.0 ** 0.5 if i < len(dims) - 2 else out_scale
            layers.append({
                "w": orthogonal(generator, (dims[i], dims[i + 1]), scale),
                "b": torch.zeros(dims[i + 1], device=generator.device),
            })
        return layers

    @staticmethod
    def _mlp_apply(layers, x):
        for i, layer in enumerate(layers):
            x = x @ layer["w"] + layer["b"]
            if i < len(layers) - 1:
                x = torch.tanh(x)
        return x

    def init(self, generator, obs_size: int, act_size: int) -> Dict[str, Any]:
        sizes = (obs_size,) + self.hidden
        q_sizes = (obs_size + act_size,) + self.hidden
        return {
            "pi": self._mlp_init(generator, sizes, 2 * act_size, 0.01),
            "q1": self._mlp_init(generator, q_sizes, 1),
            "q2": self._mlp_init(generator, q_sizes, 1),
        }

    def pi(self, params, obs):
        """-> (mean [B, A], log_std [B, A]), log_std clipped to [-20, 2]."""
        mean, log_std = torch.chunk(self._mlp_apply(params["pi"], obs), 2, dim=-1)
        return mean, torch.clamp(log_std, -20.0, 2.0)

    def q(self, params, obs, act):
        x = torch.cat([obs, act], dim=-1)
        q1 = self._mlp_apply(params["q1"], x)[..., 0]
        q2 = self._mlp_apply(params["q2"], x)[..., 0]
        return q1, q2

    def forward(self, params, obs):  # actor-critic surface (unused by SAC)
        return self.pi(params, obs)
