"""IMPALA: V-trace off-policy correction, the learner group and the V-trace
learner, port of `ray_tpu/rllib/impala.py:34-290`.

ray: rllib/algorithms/impala/impala.py:478,620 +
rllib/core/learner/learner_group.py:43. The JAX package computes V-trace as
a reverse `lax.scan` inside one jitted update; the port runs its recursion
as a loop over T, the rest as whole-[T, N] ops. Its `LearnerGroup` is one
jitted update pjit-sharded over a `learner` mesh axis; the port's is one
update on every rank of a process group, each rank on its slice of the
env axis, with the statistics and gradients that XLA would sum over the
slices summed by the port itself, so that the result is the unsharded
update's.

The algorithm class (`IMPALA`: async sample queues over runner actors)
waits for the port's copy of the actor runtime (ROADMAP A14).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.models.lm import adam
from ray_tpu_torch.models.transformer import _resolve_device
from ray_tpu_torch.parallel.sharding import tree_leaves
from ray_tpu_torch.rllib.ppo import METRICS, algorithm_not_ported, on_device, standardize
from ray_tpu_torch.rllib.rl_module import MLPModule
from ray_tpu_torch.rllib.sample_batch import ACTIONS, LOGPS, OBS


def vtrace(
    target_logps,
    behavior_logps,
    rewards,
    values,
    next_values,
    terminateds,
    dones,
    *,
    gamma: float,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
):
    """V-trace targets + policy-gradient advantages over a [T, N] rollout.

    All inputs are [T, N] tensors; `values`/`next_values` are the CURRENT
    policy's value estimates of obs/next_obs. `terminateds` zeroes the
    bootstrap (true episode end); `dones` additionally cuts the correction
    trace at time-limit truncations, whose next_values still bootstrap.
    Returns (vs [T, N], pg_advantages [T, N]).
    """
    rhos = torch.exp(target_logps - behavior_logps)
    clipped_rho = torch.clamp(rhos, max=rho_clip)
    clipped_c = torch.clamp(rhos, max=c_clip)
    discount = gamma * (1.0 - terminateds.to(values.dtype))  # per-step bootstrap discount
    deltas = clipped_rho * (rewards + discount * next_values - values)
    cont = 1.0 - dones.to(values.dtype)  # trace continues only when the episode does
    decay = discount * cont * clipped_c
    vs_minus_v = torch.empty_like(values)
    carry = torch.zeros_like(values[-1])
    for t in reversed(range(values.shape[0])):
        carry = deltas[t] + decay[t] * carry
        vs_minus_v[t] = carry
    vs = values + vs_minus_v
    # PG target: bootstrap through vs_{t+1} while the episode lives,
    # through V(next_obs) across a truncation, through nothing at a
    # true termination (discount already zero there).
    vs_next = torch.cat([vs[1:], next_values[-1:]])
    q = rewards + discount * torch.where(cont > 0.0, vs_next, next_values)
    return vs, clipped_rho * (q - values)


class LearnerGroup:
    """One update over `num_learners` ranks of a process group.

    ray: rllib/core/learner/learner_group.py:43,129. Every rank passes the
    same state and the same [T, N, ...] batch; each computes the update on
    its slice of the env axis (dim 1), the advantages standardised by the
    whole batch's statistics and the gradients averaged over the group, so
    that every rank ends with the unsharded update's state.

    With `num_learners` equal to the default process group's size the
    update runs over that group, collectives included at size 1; with one
    learner and no group it runs alone. A group of several learners spans
    every rank.
    """

    def __init__(self, update_fn: Callable, num_learners: int = 1):
        if num_learners < 1:
            raise ValueError(f"num_learners={num_learners} must be at least 1")
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        if num_learners > ranks:
            raise ValueError(f"num_learners={num_learners} > ranks in the process group {ranks}")
        if 1 < num_learners < ranks:
            raise ValueError(
                f"num_learners={num_learners} < ranks in the process group {ranks}: a "
                "learner group spans every rank"
            )
        self.num_learners = num_learners
        spans_group = dist.is_initialized() and num_learners == ranks
        self.group = dist.group.WORLD if spans_group else None
        self._update = update_fn

    def update(self, state, batch):
        for leaf in batch.values():
            if leaf.shape[1] % self.num_learners:
                raise ValueError(
                    f"env axis {leaf.shape[1]} not divisible by num_learners={self.num_learners}"
                )
        if self.group is not None and self.num_learners > 1:
            rank = dist.get_rank(self.group)

            def own(v):
                n = v.shape[1] // self.num_learners
                return v[:, rank * n:(rank + 1) * n]

            batch = {k: own(v) for k, v in batch.items()}
        return self._update(state, batch, self.group)


def _mean_over(tensors, group, n: int):
    """The tensors averaged over the ranks of `group`: one all-reduce of
    their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class IMPALAConfig:
    """Builder-style config (ray: rllib/algorithms/impala/impala.py:60)."""

    def __init__(self):
        self.env: Optional[str | Callable] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_length = 16
        self.gamma = 0.99
        self.lr = 1e-3
        self.entropy_coeff = 3e-3
        # Small because pg advantages are standardized while V-trace value
        # targets are raw returns: a large vf weight lets value gradients
        # crush the shared torso (the JAX package measured vf_coeff 0.5
        # stalling CartPole at ~40 reward; 0.01 solves it).
        self.vf_coeff = 0.01
        self.rho_clip = 1.0
        self.c_clip = 1.0
        self.num_learners = 1
        self.updates_per_iteration = 8
        self.broadcast_interval = 1  # weight refresh every N updates
        self.hidden = (64, 64)
        self.module = None  # RLModule override (ray: rl_module.py)
        self.seed = 0

    def environment(self, env: str | Callable) -> "IMPALAConfig":
        self.env = env
        return self

    def env_runners(
        self, num_env_runners: int = 2, num_envs_per_runner: int = 8,
        rollout_length: int = 16,
    ) -> "IMPALAConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        self.rollout_length = rollout_length
        return self

    _TRAINING_KEYS = frozenset(
        {
            "gamma", "lr", "entropy_coeff", "vf_coeff", "rho_clip", "c_clip",
            "num_learners", "updates_per_iteration", "broadcast_interval",
            "hidden",
        }
    )

    def training(self, **kw) -> "IMPALAConfig":
        for k, v in kw.items():
            if k not in self._TRAINING_KEYS:
                raise TypeError(
                    f"unknown IMPALA training option {k!r}; valid: "
                    f"{sorted(self._TRAINING_KEYS)}"
                )
            setattr(self, k, v)
        return self

    def rl_module(self, module) -> "IMPALAConfig":
        """Plug a custom RLModule (ray: core/rl_module/rl_module.py)."""
        self.module = module
        return self

    def debugging(self, seed: int = 0) -> "IMPALAConfig":
        self.seed = seed
        return self

    def build(self):
        raise algorithm_not_ported("IMPALA")


def make_impala_learner(
    config: IMPALAConfig, obs_size: int, num_actions: int, pg_loss_fn=None, *, device=None
):
    """(init_state, update): the V-trace actor-critic update.

    ray: rllib/algorithms/impala/vtrace_torch_policy + learner.py:657.
    `update(state, batch, group=None)` takes a time-major batch of [T, N]
    columns (`EnvRunner.sample_trajectory`), updates the state in place and
    returns (state, metrics); with a process group (`LearnerGroup`) the
    batch is this rank's slice and the statistics, gradients and metrics are
    the whole batch's.

    pg_loss_fn(logp, behavior_logp, adv) -> scalar overrides the policy
    objective on the SAME V-trace machinery (APPO passes the PPO clipped
    surrogate; None = the plain V-trace policy gradient).
    """
    device = _resolve_device(device)
    module = config.module or MLPModule(config.hidden)
    forward = module.forward
    opt = adam(config.lr)
    ent_c, vf_c = config.entropy_coeff, config.vf_coeff

    def init_state(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = module.init(gen, obs_size, num_actions)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return {"params": params, "opt_state": opt.init(params)}

    def loss_fn(params, batch, group):
        T, N = batch[ACTIONS].shape
        logits, values = forward(params, batch[OBS].reshape(T * N, obs_size))
        with torch.no_grad():
            _, next_values = forward(params, batch["next_obs"].reshape(T * N, obs_size))
        logp_all = torch.log_softmax(logits, dim=1)
        logp = logp_all.gather(1, batch[ACTIONS].reshape(-1)[:, None])[:, 0]

        vs, pg_adv = vtrace(
            logp.detach().reshape(T, N),
            batch[LOGPS],
            batch["rewards"],
            values.detach().reshape(T, N),
            next_values.reshape(T, N),
            batch["terminateds"],
            batch["dones"],
            gamma=config.gamma,
            rho_clip=config.rho_clip,
            c_clip=config.c_clip,
        )
        # Standardize advantages per batch: raw lambda=1 V-trace returns on
        # a small rollout swing over orders of magnitude, drowning the
        # entropy/value terms (same reasoning as PPO's normalization).
        adv = standardize(pg_adv.reshape(-1), group)
        if pg_loss_fn is not None:
            pg_loss = pg_loss_fn(logp, batch[LOGPS].reshape(-1), adv)
        else:
            pg_loss = -torch.mean(adv * logp)
        vf_loss = 0.5 * torch.mean((values - vs.reshape(-1)) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=1))
        total = pg_loss + vf_c * vf_loss - ent_c * entropy
        return total, (pg_loss, vf_loss, entropy)

    def update(state, batch, group=None):
        batch = on_device(batch, device)
        params = state["params"]
        leaves = tree_leaves(params)
        total, aux = loss_fn(params, batch, group)
        grads = torch.autograd.grad(total, leaves)
        metrics = torch.stack([total.detach(), *(a.detach() for a in aux)])
        if group is not None:
            # Equal slices: the mean of the ranks' means is the batch's.
            n = dist.get_world_size(group)
            *grads, metrics = _mean_over([*grads, metrics], group, n)
        opt_state = opt.update(grads, state["opt_state"], params)
        return {"params": params, "opt_state": opt_state}, dict(zip(METRICS, metrics.unbind()))

    return init_state, update
