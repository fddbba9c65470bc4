"""DQN: replay buffer, epsilon-greedy runner and the double-DQN learner,
port of `ray_tpu/rllib/dqn.py:21-226`.

ray: rllib/algorithms/dqn/. The JAX package scans an iteration's updates in
one jitted program; the port runs them as a loop of forward, autograd
backward and Adam on the card unless `device` names another. The runner's
Q-values come from the device; its exploration draws stay numpy's, as in
the JAX package.

The algorithm class (`DQN`) and offline training (`offline.py`, on
`ray_tpu.data`) wait for the port's copies of the runtime (ROADMAP A14,
A12b).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.lm import adam
from ray_tpu_torch.models.transformer import _resolve_device
from ray_tpu_torch.parallel.sharding import tree_leaves, tree_map
from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.policy import apply_policy, init_policy_params
from ray_tpu_torch.rllib.ppo import algorithm_not_ported


class ReplayBuffer:
    """Uniform ring buffer of transitions (ray: utils/replay_buffers)."""

    def __init__(self, capacity: int, obs_size: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), np.float32)
        self.next_obs = np.zeros((capacity, obs_size), np.float32)
        self.actions = np.zeros(capacity, np.int64)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.idx = 0
        self.size = 0

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        n = len(actions)
        idxs = (self.idx + np.arange(n)) % self.capacity
        self.obs[idxs] = obs
        self.actions[idxs] = actions
        self.rewards[idxs] = rewards
        self.next_obs[idxs] = next_obs
        self.dones[idxs] = dones
        self.idx = int((self.idx + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, batch_size: int, rng: np.random.Generator):
        idxs = rng.integers(0, self.size, size=batch_size)
        return (
            self.obs[idxs],
            self.actions[idxs],
            self.rewards[idxs],
            self.next_obs[idxs],
            self.dones[idxs],
        )


class _DQNRunner:
    """Rollout worker: epsilon-greedy transitions over a vectorized env, the
    greedy actions from Q-values computed on the device."""

    def __init__(self, env, num_envs: int, seed: int, *, device=None):
        self.env = make_vector_env(env, num_envs, seed=seed)
        self.rng = np.random.default_rng(seed)
        self.device = _resolve_device(device)
        self._params = None
        self._obs = self.env.reset(seed=seed)

    @torch.no_grad()
    def _q_values(self, obs) -> np.ndarray:
        obs_t = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        return apply_policy(self._params, obs_t)[0].cpu().numpy()

    def collect(self, weights, n_steps: int, epsilon: float) -> Dict[str, Any]:
        """`weights`: the learner's params (numpy arrays or tensors), copied."""
        self._params = tree_map(
            lambda w: torch.as_tensor(w).detach().to(self.device, torch.float32, copy=True),
            weights)
        N = self.env.num_envs
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        obs = self._obs
        for _ in range(n_steps):
            q = self._q_values(obs)
            greedy = q.argmax(axis=1)
            explore = self.rng.random(N) < epsilon
            actions = np.where(explore, self.rng.integers(0, q.shape[1], N), greedy)
            final_obs, rewards, terminated, truncated = self.env.step(actions)
            obs_l.append(obs)
            act_l.append(actions)
            rew_l.append(rewards)
            next_l.append(final_obs)
            done_l.append(terminated.astype(np.float32))  # truncation bootstraps
            obs = self.env.current_obs()
        self._obs = obs
        return {
            "obs": np.concatenate(obs_l),
            "actions": np.concatenate(act_l),
            "rewards": np.concatenate(rew_l),
            "next_obs": np.concatenate(next_l),
            "dones": np.concatenate(done_l),
            "episode_returns": self.env.drain_episode_returns(),
            "steps": n_steps * N,
        }


class DQNConfig:
    def __init__(self):
        self.env: Optional[str | Callable] = None
        self.num_env_runners = 1
        self.num_envs_per_runner = 8
        self.rollout_length = 32
        self.gamma = 0.99
        self.lr = 1e-3
        self.buffer_capacity = 50_000
        self.learn_batch_size = 128
        self.updates_per_iteration = 32
        self.target_sync_every = 4  # iterations
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_iters = 30
        self.hidden = (64, 64)
        self.seed = 0

    def environment(self, env) -> "DQNConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners=1, num_envs_per_runner=8, rollout_length=32):
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        self.rollout_length = rollout_length
        return self

    def training(self, **kw) -> "DQNConfig":
        valid = {
            "gamma", "lr", "buffer_capacity", "learn_batch_size",
            "updates_per_iteration", "target_sync_every", "epsilon_start",
            "epsilon_end", "epsilon_decay_iters", "hidden",
        }
        for k, v in kw.items():
            if k not in valid:
                raise TypeError(f"unknown DQN training option {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, seed: int = 0) -> "DQNConfig":
        self.seed = seed
        return self

    def build(self):
        raise algorithm_not_ported("DQN")


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor):
    """optax.huber_loss at its default delta of 1, elementwise: quadratic
    within 1 of the target, linear beyond."""
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.clamp(abs_errors, max=1.0)
    return 0.5 * quadratic ** 2 + (abs_errors - quadratic)


def _make_learner(cfg: DQNConfig, obs_size: int, num_actions: int, *, device=None):
    """(init_state, update_many, sync_target). `update_many(state, batches)`
    takes an iteration's U minibatches stacked [U, B, ...] as (obs, actions,
    rewards, next_obs, dones), updates the state in place and returns
    (state, the mean loss); `sync_target(state)` copies the online params
    into the target network."""
    device = _resolve_device(device)
    opt = adam(cfg.lr)

    def init_state(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_policy_params(gen, obs_size, num_actions, cfg.hidden)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return {
            "params": params,
            "target": tree_map(lambda p: p.detach().clone(), params),
            "opt_state": opt.init(params),
        }

    def q_of(params, obs):
        return apply_policy(params, obs)[0]  # logits head doubles as Q head

    def update_many(state, batches):
        params, target = state["params"], state["target"]
        leaves = tree_leaves(params)
        opt_state = state["opt_state"]
        batches = [torch.as_tensor(b, device=device) for b in batches]
        losses = []
        for obs, actions, rewards, next_obs, dones in zip(*batches):
            q_sa = q_of(params, obs).gather(1, actions[:, None])[:, 0]
            with torch.no_grad():
                # double DQN: online net argmax, target net evaluation
                next_a = q_of(params, next_obs).argmax(dim=1)
                next_q = q_of(target, next_obs).gather(1, next_a[:, None])[:, 0]
                y = rewards + cfg.gamma * (1.0 - dones) * next_q
            loss = huber_loss(q_sa, y).mean()
            # The value head takes no part: its gradient is zero, as jax.grad gives it.
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
            opt_state = opt.update(grads, opt_state, params)
            losses.append(loss.detach())
        return {**state, "opt_state": opt_state}, torch.stack(losses).mean()

    def sync_target(state):
        return {**state, "target": tree_map(lambda p: p.detach().clone(), state["params"])}

    return init_state, update_many, sync_target
