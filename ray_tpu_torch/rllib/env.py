"""Environments: native vectorized envs, the port's copy of
`ray_tpu/rllib/env.py` (numpy only; the port imports nothing of `ray_tpu`).

ray: rllib/env/vector_env.py + gym registration. Envs are BATCHED from the
start — a VectorEnv steps N copies with numpy vector math, so policy
inference is one batch call on the device per step instead of N scalar
calls (the reference loops Python envs one by one in evaluation/sampler.py).

CartPole dynamics follow the classic control problem definition (public
domain physics; same constants as the canonical gym task) implemented
natively — no gym dependency.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np


class VectorEnv:
    """Interface: batched reset/step over num_envs copies.

    Auto-reset semantics: when an env terminates, step() returns the
    terminal transition (done=True) and the NEXT observation is the reset
    state — the convention GAE bootstrapping expects."""

    num_envs: int
    observation_size: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(
        self, actions: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """actions [N] int → (final_obs [N, obs_size], rewards [N],
        terminated [N], truncated [N]).

        final_obs is the PRE-reset observation — callers bootstrap
        V(final_obs) for truncated (time-limit) episodes, which are not
        true terminations (the gym terminated/truncated split exists for
        exactly this GAE distinction)."""
        raise NotImplementedError


class CartPoleVectorEnv(VectorEnv):
    """N independent CartPole-v1 instances, vectorized in numpy."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500  # v1 episode cap

    num_actions = 2
    observation_size = 4

    def __init__(self, num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), dtype=np.float64)
        self._steps = np.zeros(num_envs, dtype=np.int64)
        self._episode_return = np.zeros(num_envs, dtype=np.float64)
        self.completed_episode_returns: list = []

    def _reset_indices(self, idx: np.ndarray) -> None:
        self._state[idx] = self._rng.uniform(-0.05, 0.05, size=(len(idx), 4))
        self._steps[idx] = 0
        self._episode_return[idx] = 0.0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_indices(np.arange(self.num_envs))
        return self._state.astype(np.float32).copy()

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(np.asarray(actions) == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1
        self._episode_return += 1.0

        terminated = (np.abs(x) > self.X_LIMIT) | (np.abs(theta) > self.THETA_LIMIT)
        truncated = (self._steps >= self.MAX_STEPS) & ~terminated
        rewards = np.ones(self.num_envs, dtype=np.float32)
        final_obs = self._state.astype(np.float32).copy()
        done_idx = np.nonzero(terminated | truncated)[0]
        if len(done_idx):
            self.completed_episode_returns.extend(
                self._episode_return[done_idx].tolist()
            )
            self._reset_indices(done_idx)
        return final_obs, rewards, terminated, truncated

    def current_obs(self) -> np.ndarray:
        """Post-auto-reset observations (what the policy sees next step)."""
        return self._state.astype(np.float32).copy()

    def drain_episode_returns(self) -> list:
        out = self.completed_episode_returns
        self.completed_episode_returns = []
        return out


class PendulumVectorEnv(VectorEnv):
    """N independent Pendulum-v1 instances (classic control swing-up,
    public-domain physics), vectorized in numpy.  CONTINUOUS action
    space: torque in [-max_torque, max_torque], action_size 1 — the
    continuous-control counterpart CartPole can't provide (SAC's test
    bed).  Episodes are pure time-limit truncations (no termination)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    num_actions = 1  # action_size for continuous envs
    action_size = 1
    continuous = True
    observation_size = 3  # (cos th, sin th, th_dot)

    def __init__(self, num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._th = np.zeros(num_envs)
        self._thdot = np.zeros(num_envs)
        self._steps = np.zeros(num_envs, dtype=np.int64)
        self._episode_return = np.zeros(num_envs)
        self.completed_episode_returns: list = []

    def _obs(self) -> np.ndarray:
        return np.stack(
            [np.cos(self._th), np.sin(self._th), self._thdot], axis=1
        ).astype(np.float32)

    def _reset_indices(self, idx: np.ndarray) -> None:
        self._th[idx] = self._rng.uniform(-np.pi, np.pi, size=len(idx))
        self._thdot[idx] = self._rng.uniform(-1.0, 1.0, size=len(idx))
        self._steps[idx] = 0
        self._episode_return[idx] = 0.0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_indices(np.arange(self.num_envs))
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(
            np.asarray(actions, dtype=np.float64).reshape(self.num_envs),
            -self.MAX_TORQUE,
            self.MAX_TORQUE,
        )
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (
            3.0 * self.G / (2.0 * self.L) * np.sin(th)
            + 3.0 / (self.M * self.L**2) * u
        ) * self.DT
        thdot = np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED)
        th = th + thdot * self.DT
        self._th, self._thdot = th, thdot
        self._steps += 1
        rewards = (-costs).astype(np.float32)
        self._episode_return += rewards

        final_obs = self._obs()
        terminated = np.zeros(self.num_envs, dtype=bool)
        truncated = self._steps >= self.MAX_STEPS
        done_idx = np.nonzero(truncated)[0]
        if len(done_idx):
            self.completed_episode_returns.extend(
                self._episode_return[done_idx].tolist()
            )
            self._reset_indices(done_idx)
        return final_obs, rewards, terminated, truncated

    def current_obs(self) -> np.ndarray:
        return self._obs()

    def drain_episode_returns(self) -> list:
        out = self.completed_episode_returns
        self.completed_episode_returns = []
        return out


_ENV_REGISTRY: Dict[str, Callable[..., VectorEnv]] = {
    "CartPole-v1": CartPoleVectorEnv,
    "Pendulum-v1": PendulumVectorEnv,
}


def register_env(name: str, creator: Callable[..., VectorEnv]) -> None:
    """ray: tune.register_env — creator(num_envs, seed) -> VectorEnv."""
    _ENV_REGISTRY[name] = creator


def make_vector_env(env: str | Callable, num_envs: int, seed: int = 0) -> VectorEnv:
    if callable(env):
        return env(num_envs=num_envs, seed=seed)
    if env in _ENV_REGISTRY:
        return _ENV_REGISTRY[env](num_envs=num_envs, seed=seed)
    raise ValueError(f"unknown env {env!r}; register it with register_env()")
