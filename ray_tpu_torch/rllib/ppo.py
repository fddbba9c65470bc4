"""PPO: config and learner, port of `ray_tpu/rllib/ppo.py:31-173`.

ray: rllib/algorithms/ppo/ppo.py:335,376 (PPO.training_step),
core/learner/learner.py:89 (loss/update split). The JAX package fuses the
learner's epoch x minibatch SGD into one jitted `lax.scan`; the port issues
each minibatch step's forward, autograd backward and Adam update from
Python, on the card unless `device` names another.

The algorithm class (`PPO`, its `train()`, save and restore) drives its
runners as `ray_tpu` actors and waits for the port's copy of the actor
runtime (ROADMAP A14). Meanwhile a caller drives `EnvRunner`s and the
learner of `_make_learner` in its own process: the dataflow of
`PPO.train()` without the actor hop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.models.lm import adam
from ray_tpu_torch.models.transformer import _resolve_device
from ray_tpu_torch.parallel.sharding import tree_leaves
from ray_tpu_torch.rllib.rl_module import MLPModule
from ray_tpu_torch.rllib.sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS

METRICS = ("total_loss", "policy_loss", "vf_loss", "entropy")


def algorithm_not_ported(name: str) -> NotImplementedError:
    """What a config's `build()` raises: the algorithm classes wait for the
    actor runtime."""
    return NotImplementedError(
        f"{name}: the algorithm class drives its env runners as ray_tpu actors, and the "
        "port has no copy of the actor runtime yet (ROADMAP A14, then A12b). Drive the "
        "env runners and the learner in-process meanwhile."
    )


class PPOConfig:
    """Builder-style config (ray: rllib/algorithms/algorithm_config.py)."""

    def __init__(self):
        self.env: Optional[str | Callable] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_length = 64
        self.gamma = 0.99
        self.lam = 0.95
        self.lr = 3e-4
        self.clip_param = 0.2
        self.entropy_coeff = 0.01
        self.vf_coeff = 0.5
        self.num_epochs = 4
        self.minibatch_size = 256
        self.hidden = (64, 64)
        self.module = None  # RLModule override (ray: rl_module.py)
        self.seed = 0

    # -- builder sections (mirror the reference's fluent API) -------------
    def environment(self, env: str | Callable) -> "PPOConfig":
        self.env = env
        return self

    def env_runners(
        self, num_env_runners: int = 2, num_envs_per_runner: int = 8,
        rollout_length: int = 64,
    ) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        self.rollout_length = rollout_length
        return self

    _TRAINING_KEYS = frozenset(
        {
            "gamma", "lam", "lr", "clip_param", "entropy_coeff", "vf_coeff",
            "num_epochs", "minibatch_size", "hidden",
        }
    )

    def training(self, **kw) -> "PPOConfig":
        for k, v in kw.items():
            if k not in self._TRAINING_KEYS:
                raise TypeError(
                    f"unknown PPO training option {k!r}; valid: "
                    f"{sorted(self._TRAINING_KEYS)}"
                )
            setattr(self, k, v)
        return self

    def rl_module(self, module) -> "PPOConfig":
        """Plug a custom RLModule (ray: core/rl_module/rl_module.py)."""
        self.module = module
        return self

    def debugging(self, seed: int = 0) -> "PPOConfig":
        self.seed = seed
        return self

    def build(self):
        raise algorithm_not_ported("PPO")


def standardize(x: torch.Tensor, group=None) -> torch.Tensor:
    """(x - mean) / (std + 1e-8) over every element of x, with the
    population std (ddof 0, as jnp.std; torch.std's default is ddof 1).

    With a process group, x is this rank's shard of the batch and the
    statistics are the whole batch's: the sum and count, then the sum of
    squared deviations, are summed over the group before use."""
    stats = torch.stack([x.sum(), torch.full((), float(x.numel()), device=x.device)])
    if group is not None:
        dist.all_reduce(stats, group=group)
    mean = stats[0] / stats[1]
    sq = torch.square(x - mean).sum()
    if group is not None:
        dist.all_reduce(sq, group=group)
    return (x - mean) / (torch.sqrt(sq / stats[1]) + 1e-8)


def on_device(batch, device) -> dict:
    """A batch (dict of numpy arrays or tensors) as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """The learner's one draw: a permutation of range(n) on the generator's
    device."""
    return torch.randperm(n, generator=generator, device=generator.device)


def _make_learner(config: PPOConfig, obs_size: int, num_actions: int, *, device=None):
    """Build (init_state, update). `init_state(seed)` is the learner's state,
    {"params", "opt_state", "rng"} (the permutations' generator);
    `update(state, batch)` runs epochs x minibatches of SGD on a batch of [B]
    columns, one permutation per epoch, updates the state in place and
    returns (state, metrics), the metrics' means over every minibatch step,
    on the device until read."""
    device = _resolve_device(device)
    module = config.module or MLPModule(config.hidden)
    forward = module.forward
    opt = adam(config.lr)
    clip, ent_c, vf_c = config.clip_param, config.entropy_coeff, config.vf_coeff

    def init_state(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = module.init(gen, obs_size, num_actions)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return {"params": params, "opt_state": opt.init(params), "rng": gen}

    def loss_fn(params, mb):
        logits, values = forward(params, mb[OBS])
        logp_all = torch.log_softmax(logits, dim=1)
        logp = logp_all.gather(1, mb[ACTIONS][:, None])[:, 0]
        ratio = torch.exp(logp - mb[LOGPS])
        adv = standardize(mb[ADVANTAGES])
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        vf_loss = torch.mean((values - mb[RETURNS]) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=1))
        total = pg_loss + vf_c * vf_loss - ent_c * entropy
        return total, (pg_loss, vf_loss, entropy)

    def update(state, batch):
        batch = on_device(batch, device)
        B = batch[ACTIONS].shape[0]
        mb_size = min(config.minibatch_size, B)
        n_mb = max(B // mb_size, 1)
        used = n_mb * mb_size
        params, opt_state, gen = state["params"], state["opt_state"], state["rng"]
        leaves = tree_leaves(params)
        metrics = []
        for _ in range(config.num_epochs):
            perm = _permutation(B, gen)[:used]
            for idx in perm.view(n_mb, mb_size):
                mb = {k: v[idx] for k, v in batch.items()}
                total, aux = loss_fn(params, mb)
                grads = torch.autograd.grad(total, leaves)
                opt_state = opt.update(grads, opt_state, params)
                metrics.append(torch.stack([total.detach(), *(a.detach() for a in aux)]))
        means = torch.stack(metrics).mean(dim=0)
        return ({"params": params, "opt_state": opt_state, "rng": gen},
                dict(zip(METRICS, means.unbind())))

    return init_state, update
