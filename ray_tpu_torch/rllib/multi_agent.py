"""Multi-agent RL: env API, rollout runner and the per-policy PPO learners,
port of `ray_tpu/rllib/multi_agent.py:33-334`.

ray: rllib/env/multi_agent_env.py (MultiAgentEnv — dict-keyed obs/action/
reward spaces per agent) + the policy-mapping machinery in
rllib/policy/policy_map.py. Every agent's env axis is VECTORIZED (an
agent's observations across N env copies are one [N, obs] batch → one
policy call per agent per step), and each policy trains with PPO's learner
(ppo.py) on the pooled batch of its agents.

The algorithm class (`MultiAgentPPO`) waits for the port's copy of the
actor runtime (ROADMAP A14); `make_policy_learners` builds its learners.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env import CartPoleVectorEnv
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.ppo import PPOConfig, _make_learner, algorithm_not_ported
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    LOGPS,
    OBS,
    RETURNS,
    SampleBatch,
    compute_gae,
)


class MultiAgentVectorEnv:
    """N vectorized copies of an M-agent environment.

    Dict-keyed batched surface (ray: MultiAgentEnv's per-agent dicts,
    vectorized here): reset/step take and return {agent_id: [N, ...]}.
    Agents are fixed for the episode (no agent death/spawn in v1).
    """

    num_envs: int
    agent_ids: List[str]

    def observation_size(self, agent_id: str) -> int:
        raise NotImplementedError

    def num_actions(self, agent_id: str) -> int:
        raise NotImplementedError

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, np.ndarray]):
        """actions {agent: [N]} → (final_obs {agent: [N, obs]},
        rewards {agent: [N]}, terminated [N], truncated [N]).
        Termination is per-ENV (all agents end together — the common
        cooperative/competitive episode structure)."""
        raise NotImplementedError

    def current_obs(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def drain_episode_returns(self) -> Dict[str, list]:
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentVectorEnv):
    """M independent CartPoles sharing an episode clock (ray: the
    MultiAgentCartPole used across rllib's multi-agent test suites).  An
    env copy ends when EVERY agent's pole has dropped (failed agents
    accrue zero reward while waiting) or the step cap hits."""

    def __init__(self, num_envs: int = 8, num_agents: int = 2, seed: int = 0):
        self.num_envs = num_envs
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {
            aid: CartPoleVectorEnv(num_envs, seed=seed + 91 * i)
            for i, aid in enumerate(self.agent_ids)
        }
        self._alive = {
            aid: np.ones(num_envs, dtype=bool) for aid in self.agent_ids
        }
        self._steps = np.zeros(num_envs, dtype=np.int64)
        self._ep_return = {
            aid: np.zeros(num_envs) for aid in self.agent_ids
        }
        self.completed: Dict[str, list] = {aid: [] for aid in self.agent_ids}
        self.max_steps = 200

    def observation_size(self, agent_id):
        return 4

    def num_actions(self, agent_id):
        return 2

    def reset(self, seed=None):
        out = {}
        for i, (aid, env) in enumerate(self._envs.items()):
            # Distinct per-agent seed offsets: one shared seed would give
            # every agent an identical RNG stream (perfectly correlated
            # trajectories — degenerate experience for pooled policies).
            out[aid] = env.reset(None if seed is None else seed + 91 * i)
            self._alive[aid][:] = True
            self._ep_return[aid][:] = 0.0
        self._steps[:] = 0
        return out

    def step(self, actions):
        N = self.num_envs
        final_obs, rewards = {}, {}
        for aid, env in self._envs.items():
            obs_a, rew_a, term_a, trunc_a = env.step(actions[aid])
            # The wrapper tracks episode returns itself: discard the
            # sub-env's own completed-episode list or it grows unbounded
            # across the run (one float per sub-episode per agent forever).
            env.completed_episode_returns.clear()
            # A dropped pole freezes that agent's reward; its sub-env auto-
            # reset but the shared episode keeps running for the others.
            rew_a = rew_a * self._alive[aid]
            self._alive[aid] &= ~(term_a | trunc_a)
            self._ep_return[aid] += rew_a
            final_obs[aid] = obs_a
            rewards[aid] = rew_a
        self._steps += 1
        all_done = ~np.logical_or.reduce(
            [self._alive[aid] for aid in self.agent_ids]
        )
        terminated = all_done
        truncated = (self._steps >= self.max_steps) & ~terminated
        # Per-agent liveness AT this step (pre-reset), for value
        # bootstrapping: a dead-but-frozen agent's final_obs belongs to a
        # ghost sub-episode and must not be bootstrapped.
        self.last_alive = {aid: self._alive[aid].copy() for aid in self.agent_ids}
        done_idx = np.nonzero(terminated | truncated)[0]
        if len(done_idx):
            for aid in self.agent_ids:
                self.completed[aid].extend(self._ep_return[aid][done_idx].tolist())
                self._ep_return[aid][done_idx] = 0.0
                self._alive[aid][done_idx] = True
                self._envs[aid]._reset_indices(done_idx)
            self._steps[done_idx] = 0
        return final_obs, rewards, terminated, truncated

    def current_obs(self):
        return {aid: env.current_obs() for aid, env in self._envs.items()}

    def drain_episode_returns(self):
        out = self.completed
        self.completed = {aid: [] for aid in self.agent_ids}
        return out


class MultiAgentEnvRunner:
    """Rollout worker over a multi-agent env: one policy call PER AGENT per
    step (each a full [N]-env batch, on the device), GAE per agent under ITS
    policy's value head, batches grouped by policy id for the learners
    (ray: rollout_worker.py multi-agent sample collection)."""

    def __init__(
        self,
        env_creator: Callable,
        num_envs: int,
        rollout_length: int,
        policy_mapping: Dict[str, str],
        *,
        gamma: float = 0.99,
        lam: float = 0.95,
        seed: int = 0,
        hidden=(64, 64),
        device=None,
    ):
        self.env: MultiAgentVectorEnv = env_creator(num_envs=num_envs, seed=seed)
        self.rollout_length = rollout_length
        self.policy_mapping = dict(policy_mapping)
        self.gamma, self.lam = gamma, lam
        self.policies: Dict[str, TorchPolicy] = {}
        for i, pid in enumerate(sorted(set(self.policy_mapping.values()))):
            aid = next(a for a, p in self.policy_mapping.items() if p == pid)
            self.policies[pid] = TorchPolicy(
                self.env.observation_size(aid),
                self.env.num_actions(aid),
                seed=seed + 7 * i,
                hidden=hidden,
                device=device,
            )
        self._obs = self.env.reset(seed=seed)

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)

    def sample(self, weights: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if weights is not None:
            self.set_weights(weights)
        T, N = self.rollout_length, self.env.num_envs
        agents = self.env.agent_ids
        bufs = {
            aid: {
                "obs": np.zeros((T, N, self.env.observation_size(aid)), np.float32),
                "act": np.zeros((T, N), np.int64),
                "logp": np.zeros((T, N), np.float32),
                "val": np.zeros((T, N), np.float32),
                "rew": np.zeros((T, N), np.float32),
            }
            for aid in agents
        }
        done_buf = np.zeros((T, N), dtype=bool)

        obs = self._obs
        for t in range(T):
            acts = {}
            for aid in agents:
                pol = self.policies[self.policy_mapping[aid]]
                a, lp, v = pol.compute_actions(obs[aid])
                b = bufs[aid]
                b["obs"][t], b["act"][t], b["logp"][t], b["val"][t] = (
                    obs[aid], a, lp, v
                )
                acts[aid] = a
            final_obs, rewards, terminated, truncated = self.env.step(acts)
            if truncated.any():
                # Time-limit cutoffs bootstrap each agent's OWN value of
                # its final observation (same GAE reasoning as the
                # single-agent runner, env_runner.py): without it, good
                # policies that reach the cap learn V(late state) ~ 0.
                # Only for agents still ALIVE at the cutoff — a dead
                # agent's final_obs is a ghost sub-episode state and a
                # bootstrap there injects phantom return.
                alive = getattr(self.env, "last_alive", None)
                for aid in agents:
                    mask = truncated if alive is None else (truncated & alive[aid])
                    idx = np.nonzero(mask)[0]
                    if not len(idx):
                        continue
                    pol = self.policies[self.policy_mapping[aid]]
                    _, _, v_fin = pol.compute_actions(final_obs[aid])
                    rew = rewards[aid].copy()
                    rew[idx] += self.gamma * v_fin[idx]
                    rewards[aid] = rew
            for aid in agents:
                bufs[aid]["rew"][t] = rewards[aid]
            done_buf[t] = terminated | truncated
            obs = self.env.current_obs()
        self._obs = obs

        # Per-policy batches: each agent post-processes GAE under its own
        # policy's bootstrap, then batches concat per policy id.
        per_policy: Dict[str, List[SampleBatch]] = {}
        for aid in agents:
            pid = self.policy_mapping[aid]
            pol = self.policies[pid]
            _, _, last_v = pol.compute_actions(obs[aid])
            b = bufs[aid]
            adv, rets = compute_gae(
                b["rew"], b["val"], done_buf, last_v, self.gamma, self.lam
            )
            per_policy.setdefault(pid, []).append(
                SampleBatch(
                    {
                        OBS: b["obs"].reshape(T * N, -1),
                        ACTIONS: b["act"].reshape(-1),
                        LOGPS: b["logp"].reshape(-1),
                        ADVANTAGES: adv.reshape(-1),
                        RETURNS: rets.reshape(-1),
                    }
                )
            )
        return {
            "batches": {
                pid: dict(SampleBatch.concat_samples(bs))
                for pid, bs in per_policy.items()
            },
            "episode_returns": self.env.drain_episode_returns(),
            "steps": T * N * len(agents),
        }



class MultiAgentPPOConfig:
    """Builder config (ray: AlgorithmConfig.multi_agent(policies=...,
    policy_mapping_fn=...))."""

    def __init__(self):
        self.env_creator: Optional[Callable] = None
        self.policy_mapping: Dict[str, str] = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_length = 32
        self.gamma = 0.99
        self.lam = 0.95
        self.lr = 1e-3
        self.clip_param = 0.2
        self.entropy_coeff = 5e-3
        self.vf_coeff = 0.5
        self.num_epochs = 8
        self.minibatch_size = 128
        self.hidden = (64, 64)
        self.seed = 0

    def environment(self, env_creator: Callable) -> "MultiAgentPPOConfig":
        self.env_creator = env_creator
        return self

    def multi_agent(self, policy_mapping: Dict[str, str]) -> "MultiAgentPPOConfig":
        """policy_mapping: agent_id -> policy_id.  Agents sharing a policy
        id train ONE set of params on their pooled experience."""
        self.policy_mapping = dict(policy_mapping)
        return self

    def env_runners(
        self, num_env_runners: int = 2, num_envs_per_runner: int = 8,
        rollout_length: int = 32,
    ) -> "MultiAgentPPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        self.rollout_length = rollout_length
        return self

    def training(self, **kw) -> "MultiAgentPPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k) or k in ("env_creator", "policy_mapping"):
                raise TypeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, seed: int = 0) -> "MultiAgentPPOConfig":
        self.seed = seed
        return self

    def build(self):
        raise algorithm_not_ported("MultiAgentPPO")


def make_policy_learners(config: MultiAgentPPOConfig, *, device=None):
    """One PPO learner PER policy id, as `MultiAgentPPO.__init__` builds
    them: (policy ids, {pid: update}, {pid: initial state}), the states
    seeded config.seed + 13 * i in sorted policy-id order. Shared policies
    train on the pooled batch of all their agents."""
    if config.env_creator is None or not config.policy_mapping:
        raise ValueError("set .environment(creator) and .multi_agent(mapping)")
    probe = config.env_creator(num_envs=1, seed=0)
    policy_ids = sorted(set(config.policy_mapping.values()))
    pc = PPOConfig()
    for k in (
        "gamma", "lam", "lr", "clip_param", "entropy_coeff", "vf_coeff",
        "num_epochs", "minibatch_size", "hidden",
    ):
        setattr(pc, k, getattr(config, k))
    updates, states = {}, {}
    for i, pid in enumerate(policy_ids):
        aid = next(a for a, p in config.policy_mapping.items() if p == pid)
        init_state, updates[pid] = _make_learner(
            pc, probe.observation_size(aid), probe.num_actions(aid), device=device
        )
        states[pid] = init_state(config.seed + 13 * i)
    return policy_ids, updates, states
