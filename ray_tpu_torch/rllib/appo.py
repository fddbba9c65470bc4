"""APPO: asynchronous PPO (IMPALA architecture + clipped surrogate), port of
`ray_tpu/rllib/appo.py`.

ray: rllib/algorithms/appo/appo.py — PPO's clipped-surrogate objective on
IMPALA's actor-learner machinery, with V-trace correcting the sampling lag:
IMPALA's learner with its policy loss swapped for the PPO clip applied to
V-trace advantages (make_impala_learner's pg_loss_fn hook).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.impala import IMPALAConfig, make_impala_learner
from ray_tpu_torch.rllib.ppo import algorithm_not_ported


class APPOConfig(IMPALAConfig):
    """IMPALA's knobs + the PPO clip (ray: appo.py APPOConfig). vf_coeff
    keeps IMPALA's small default (0.01): advantages are standardized while
    V-trace value targets are raw returns, and a large vf weight lets value
    gradients crush the shared torso."""

    def __init__(self):
        super().__init__()
        self.clip_param = 0.2

    _TRAINING_KEYS = IMPALAConfig._TRAINING_KEYS | {"clip_param"}

    def build(self):
        raise algorithm_not_ported("APPO")


def make_appo_learner(config: APPOConfig, obs_size: int, num_actions: int, *, device=None):
    """IMPALA's V-trace learner with the PPO clipped surrogate as the
    policy objective (ray: appo_torch_policy's surrogate over vtrace;
    the behavior policy's logp is the ratio denominator)."""
    clip = config.clip_param

    def clipped_surrogate(logp, behavior_logp, adv):
        ratio = torch.exp(logp - behavior_logp)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
        return -torch.mean(torch.minimum(pg1, pg2))

    return make_impala_learner(config, obs_size, num_actions, pg_loss_fn=clipped_surrogate,
                               device=device)
