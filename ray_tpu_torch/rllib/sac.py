"""SAC: replay buffer, runner and the soft actor-critic learner, port of
`ray_tpu/rllib/sac.py:23-296`.

ray: rllib/algorithms/sac/sac.py — off-policy maximum-entropy RL with a
squashed-Gaussian actor, twin Q critics, polyak-averaged targets and
automatic entropy-temperature tuning. The JAX package fuses the update
(critics, actor, alpha, polyak) into one jitted program; the port issues it
from Python in the same order, on the card unless `device` names another,
with the Gaussian noise from the learner's generator. Replay sampling stays
host-side numpy.

The algorithm class (`SAC`) waits for the port's copy of the actor runtime
(ROADMAP A14).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.lm import adam
from ray_tpu_torch.models.transformer import _resolve_device
from ray_tpu_torch.parallel.sharding import tree_leaves, tree_map
from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.ppo import algorithm_not_ported, on_device
from ray_tpu_torch.rllib.rl_module import ContinuousMLPModule


class ContinuousReplayBuffer:
    """Numpy ring buffer with float action vectors (the DQN buffer stores
    int action ids; ray: replay_buffers/replay_buffer.py)."""

    def __init__(self, capacity: int, obs_size: int, act_size: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), dtype=np.float32)
        self.actions = np.zeros((capacity, act_size), dtype=np.float32)
        self.rewards = np.zeros(capacity, dtype=np.float32)
        self.next_obs = np.zeros((capacity, obs_size), dtype=np.float32)
        self.terminateds = np.zeros(capacity, dtype=np.float32)
        self.size = 0
        self._idx = 0

    def add_batch(self, obs, actions, rewards, next_obs, terminateds) -> None:
        n = len(obs)
        idx = (self._idx + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.next_obs[idx] = next_obs
        self.terminateds[idx] = terminateds
        self._idx = (self._idx + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def sample(self, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "terminateds": self.terminateds[idx],
        }


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    """The SAC learner's and runner's one draw: standard normal noise on the
    generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device)


class _SACRunner:
    """Steps a continuous VectorEnv with the squashed-Gaussian actor (batch
    inference on the device)."""

    def __init__(self, env, num_envs: int, seed: int, hidden, act_limit: float, *,
                 device=None):
        self.env = make_vector_env(env, num_envs, seed=seed)
        self.module = ContinuousMLPModule(hidden)
        self.act_limit = act_limit
        self.device = _resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._params = None
        self._obs = self.env.reset(seed=seed)

    @torch.no_grad()
    def _act(self, obs) -> np.ndarray:
        mean, log_std = self.module.pi(
            self._params, torch.as_tensor(obs, dtype=torch.float32, device=self.device))
        eps = _normal(mean.shape, self.generator)
        return (torch.tanh(mean + torch.exp(log_std) * eps) * self.act_limit).cpu().numpy()

    def collect(self, params, n_steps: int, random_actions: bool = False) -> Dict[str, Any]:
        """`params`: the learner's (numpy arrays or tensors, copied), or None
        to keep the last ones."""
        if params is not None:
            self._params = tree_map(
                lambda w: torch.as_tensor(w).detach().to(self.device, torch.float32, copy=True),
                params)
        N = self.env.num_envs
        cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "terminateds")}
        obs = self._obs
        # A fresh numpy stream per collect for the warm-up's uniform actions:
        # one seed would replay the same action sequence every call.
        seed = int(torch.randint(0, 2**31 - 1, (), generator=self.generator,
                                 device=self.device))
        rng = np.random.default_rng(seed)
        for _ in range(n_steps):
            if random_actions or self._params is None:
                acts = rng.uniform(
                    -self.act_limit, self.act_limit,
                    size=(N, self.env.action_size),
                ).astype(np.float32)
            else:
                acts = self._act(obs)
            final_obs, rewards, terminated, _trunc = self.env.step(acts)
            cols["obs"].append(obs)
            cols["actions"].append(acts)
            cols["rewards"].append(rewards)
            cols["next_obs"].append(final_obs)
            cols["terminateds"].append(terminated.astype(np.float32))
            obs = self.env.current_obs()
        self._obs = obs
        return {
            "batch": {k: np.concatenate(v, axis=0) for k, v in cols.items()},
            "episode_returns": self.env.drain_episode_returns(),
            "steps": n_steps * N,
        }


class SACConfig:
    """Builder-style config (ray: sac.py SACConfig)."""

    def __init__(self):
        self.env = None
        self.num_env_runners = 1
        self.num_envs_per_runner = 8
        self.rollout_length = 32
        self.gamma = 0.99
        self.lr = 3e-4
        self.tau = 0.005  # polyak
        self.batch_size = 256
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.updates_per_iteration = 64
        self.act_limit = 2.0
        self.target_entropy: Optional[float] = None  # default: -act_size
        self.hidden = (128, 128)
        self.seed = 0

    def environment(self, env) -> "SACConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners=1, num_envs_per_runner=8,
                    rollout_length=32) -> "SACConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        self.rollout_length = rollout_length
        return self

    _TRAINING_KEYS = frozenset(
        {
            "gamma", "lr", "tau", "batch_size", "buffer_capacity",
            "learning_starts", "updates_per_iteration", "act_limit",
            "target_entropy", "hidden",
        }
    )

    def training(self, **kw) -> "SACConfig":
        for k, v in kw.items():
            if k not in self._TRAINING_KEYS:
                raise TypeError(
                    f"unknown SAC training option {k!r}; valid: "
                    f"{sorted(self._TRAINING_KEYS)}"
                )
            setattr(self, k, v)
        return self

    def debugging(self, seed: int = 0) -> "SACConfig":
        self.seed = seed
        return self

    def build(self):
        raise algorithm_not_ported("SAC")


SAC_METRICS = ("q_loss", "pi_loss", "alpha", "entropy")


def make_sac_learner(config: SACConfig, obs_size: int, act_size: int, *, device=None):
    """(init_state, update): twin critics, actor, temperature and polyak
    (ray: sac_torch_policy's three optimizers). `update(state, batch)` takes
    a dict of [B] columns (`ContinuousReplayBuffer.sample`), updates the
    state in place and returns (state, metrics).

    The order is the JAX package's: the critics on the current params; the
    actor on the params after the critics' update; the temperature on the
    actor's pre-update log-probs; polyak over every leaf, the actor's
    included. Targets and log-probs are detached where JAX stops the
    gradient."""
    device = _resolve_device(device)
    module = ContinuousMLPModule(config.hidden)
    limit = config.act_limit
    target_ent = (
        config.target_entropy if config.target_entropy is not None else -float(act_size)
    )
    pi_opt, q_opt, a_opt = adam(config.lr), adam(config.lr), adam(config.lr)
    gamma, tau = config.gamma, config.tau

    def sample_action(params, obs, generator):
        """Reparameterized squashed-Gaussian sample + log-prob with the
        tanh change-of-variables correction."""
        mean, log_std = module.pi(params, obs)
        std = torch.exp(log_std)
        pre = mean + std * _normal(mean.shape, generator)
        act = torch.tanh(pre)
        logp = (-0.5 * (((pre - mean) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
        logp = logp - torch.sum(torch.log(1 - act ** 2 + 1e-6), dim=-1)
        return act * limit, logp

    def init_state(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = module.init(gen, obs_size, act_size)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        q_params = {"q1": params["q1"], "q2": params["q2"]}
        log_alpha = torch.zeros((), device=device, requires_grad=True)
        return {
            "params": params,
            "target": tree_map(lambda p: p.detach().clone(), params),
            "pi_opt": pi_opt.init(params["pi"]),
            "q_opt": q_opt.init(q_params),
            "log_alpha": log_alpha,
            "a_opt": a_opt.init(log_alpha),
            "rng": gen,
        }

    def update(state, batch):
        batch = on_device(batch, device)
        params, target, gen = state["params"], state["target"], state["rng"]
        q_params = {"q1": params["q1"], "q2": params["q2"]}
        alpha = torch.exp(state["log_alpha"].detach())

        # -- critic ----------------------------------------------------
        with torch.no_grad():
            next_act, next_logp = sample_action(params, batch["next_obs"], gen)
            tq1, tq2 = module.q(target, batch["next_obs"], next_act)
            y = batch["rewards"] + gamma * (1.0 - batch["terminateds"]) * (
                torch.minimum(tq1, tq2) - alpha * next_logp
            )
        q1, q2 = module.q(params, batch["obs"], batch["actions"])
        q_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)
        q_grads = torch.autograd.grad(q_loss, tree_leaves(q_params))
        q_opt_state = q_opt.update(q_grads, state["q_opt"], q_params)

        # -- actor, on the critics just updated ------------------------
        act, logp = sample_action(params, batch["obs"], gen)
        q1, q2 = module.q(params, batch["obs"], act)
        pi_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        pi_grads = torch.autograd.grad(pi_loss, tree_leaves(params["pi"]))
        pi_opt_state = pi_opt.update(pi_grads, state["pi_opt"], params["pi"])
        logp = logp.detach()  # the actor's pre-update log-probs

        # -- temperature ----------------------------------------------
        log_alpha = state["log_alpha"]
        a_loss = -torch.mean(torch.exp(log_alpha) * (logp + target_ent))
        a_grads = torch.autograd.grad(a_loss, [log_alpha])
        a_opt_state = a_opt.update(a_grads, state["a_opt"], log_alpha)

        # -- polyak target --------------------------------------------
        with torch.no_grad():
            t_leaves = tree_leaves(target)
            torch._foreach_mul_(t_leaves, 1.0 - tau)
            torch._foreach_add_(t_leaves, tree_leaves(params), alpha=tau)
        metrics = torch.stack([q_loss.detach(), pi_loss.detach(),
                               torch.exp(log_alpha.detach()), -torch.mean(logp)])
        return {
            "params": params,
            "target": target,
            "pi_opt": pi_opt_state,
            "q_opt": q_opt_state,
            "log_alpha": log_alpha,
            "a_opt": a_opt_state,
            "rng": gen,
        }, dict(zip(SAC_METRICS, metrics.unbind()))

    return init_state, update
