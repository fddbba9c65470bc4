"""EnvRunner: the rollout worker, port of `ray_tpu/rllib/env_runner.py`.

ray: rllib/evaluation/rollout_worker.py:165,885 (RolloutWorker.sample). The
runner steps a VECTORIZED env and calls the policy once per step on the
whole env batch (one batch call on the device), instead of the reference's
per-env Python sampling loop. GAE post-processing happens runner-side
(matching the reference's postprocess_trajectory placement) so the learner
receives ready-to-train columns. The policy runs on the card unless
`device` names another.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    LOGPS,
    OBS,
    RETURNS,
    SampleBatch,
    compute_gae,
)


class EnvRunner:
    """Owns a VectorEnv + a TorchPolicy copy."""

    def __init__(
        self,
        env: str | Callable,
        num_envs: int,
        rollout_length: int,
        *,
        gamma: float = 0.99,
        lam: float = 0.95,
        seed: int = 0,
        hidden=(64, 64),
        module=None,
        device=None,
    ):
        self.env = make_vector_env(env, num_envs, seed=seed)
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.lam = lam
        self.policy = TorchPolicy(
            self.env.observation_size, self.env.num_actions, seed=seed,
            hidden=hidden, module=module, device=device,
        )
        self._obs = self.env.reset(seed=seed)

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def sample(self, weights: Optional[Any] = None) -> Dict[str, Any]:
        """Collect rollout_length × num_envs steps; returns a flat
        SampleBatch (dict of [T*N] arrays) + episode stats."""
        if weights is not None:
            self.policy.set_weights(weights)
        T, N = self.rollout_length, self.env.num_envs
        obs_buf = np.zeros((T, N, self.env.observation_size), dtype=np.float32)
        act_buf = np.zeros((T, N), dtype=np.int64)
        logp_buf = np.zeros((T, N), dtype=np.float32)
        val_buf = np.zeros((T, N), dtype=np.float32)
        rew_buf = np.zeros((T, N), dtype=np.float32)
        done_buf = np.zeros((T, N), dtype=bool)

        obs = self._obs
        for t in range(T):
            actions, logps, values = self.policy.compute_actions(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logps
            val_buf[t] = values
            final_obs, rewards, terminated, truncated = self.env.step(actions)
            if truncated.any():
                # Time-limit cutoffs are NOT terminations: bootstrap the
                # truncated state's value into the reward so GAE doesn't
                # learn conflicting V-targets for late-episode states.
                # Evaluated on the full [N] batch and indexed on the host,
                # as the JAX package does.
                idx = np.nonzero(truncated)[0]
                _, _, v_final = self.policy.compute_actions(final_obs)
                rewards = rewards.copy()
                rewards[idx] += self.gamma * v_final[idx]
            rew_buf[t] = rewards
            done_buf[t] = terminated | truncated  # both cut the GAE trace
            obs = self.env.current_obs()
        self._obs = obs

        # Bootstrap the value of the final observation for unfinished envs.
        _, _, last_values = self.policy.compute_actions(obs)
        adv, rets = compute_gae(
            rew_buf, val_buf, done_buf, last_values, self.gamma, self.lam
        )
        # Only the columns the learner consumes are shipped (REWARDS/DONES/
        # VALUES already did their job in the GAE computation above).
        batch = SampleBatch(
            {
                OBS: obs_buf.reshape(T * N, -1),
                ACTIONS: act_buf.reshape(-1),
                LOGPS: logp_buf.reshape(-1),
                ADVANTAGES: adv.reshape(-1),
                RETURNS: rets.reshape(-1),
            }
        )
        return {
            "batch": dict(batch),
            "episode_returns": self.env.drain_episode_returns(),
            "steps": T * N,
        }

    def sample_trajectory(
        self, weights: Optional[Any] = None, weights_version: int = 0
    ) -> Dict[str, Any]:
        """Collect a TIME-MAJOR raw trajectory for off-policy learners
        (IMPALA — ray: rllib/algorithms/impala/impala.py:478).

        Unlike `sample()` (which post-processes GAE runner-side for PPO),
        this ships the behavior policy's raw experience: the learner computes
        values under its OWN current params and applies V-trace importance
        correction for the sampling lag.  `next_obs` is the pre-reset
        observation of every step, so the learner can bootstrap through
        time-limit truncations exactly (terminated cuts the return;
        truncated bootstraps V(next_obs) but still cuts the trace).
        """
        if weights is not None:
            self.policy.set_weights(weights)
        T, N = self.rollout_length, self.env.num_envs
        obs_buf = np.zeros((T, N, self.env.observation_size), dtype=np.float32)
        next_obs_buf = np.zeros_like(obs_buf)
        act_buf = np.zeros((T, N), dtype=np.int64)
        logp_buf = np.zeros((T, N), dtype=np.float32)
        rew_buf = np.zeros((T, N), dtype=np.float32)
        term_buf = np.zeros((T, N), dtype=bool)
        done_buf = np.zeros((T, N), dtype=bool)

        obs = self._obs
        for t in range(T):
            actions, logps, _ = self.policy.compute_actions(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logps
            final_obs, rewards, terminated, truncated = self.env.step(actions)
            next_obs_buf[t] = final_obs
            rew_buf[t] = rewards
            term_buf[t] = terminated
            done_buf[t] = terminated | truncated
            obs = self.env.current_obs()
        self._obs = obs

        return {
            "batch": {
                OBS: obs_buf,
                "next_obs": next_obs_buf,
                ACTIONS: act_buf,
                LOGPS: logp_buf,
                "rewards": rew_buf,
                "terminateds": term_buf,
                "dones": done_buf,
            },
            "episode_returns": self.env.drain_episode_returns(),
            "steps": T * N,
            "weights_version": weights_version,
        }
