"""ray_tpu_torch.rllib — the RL learners, env runners and envs, port of
`ray_tpu/rllib/`.

ray: rllib/ — the new Learner stack (core/learner/learner.py:89) over
vectorized envs (one policy call on the device per step for the whole env
batch). The learners (PPO, IMPALA's V-trace, APPO, DQN, SAC, per-policy
multi-agent PPO) run on the card unless the caller passes `device="cpu"`,
each update issued from Python: forward, autograd backward, the port's own
Adam. Their random draws come from explicit `torch.Generator`s.

The algorithm classes (`PPO`, `IMPALA`, ... and their `train()`) drive
their runners as `ray_tpu` actors and wait for the port's copy of the actor
runtime (ROADMAP A14, then A12b); the configs' `build()` raises until then.
A caller drives the runners and the learner in one process meanwhile.
"""

from ray_tpu_torch.rllib.appo import APPOConfig, make_appo_learner
from ray_tpu_torch.rllib.dqn import DQNConfig, ReplayBuffer
from ray_tpu_torch.rllib.env import (
    CartPoleVectorEnv,
    PendulumVectorEnv,
    VectorEnv,
    make_vector_env,
    register_env,
)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.impala import IMPALAConfig, LearnerGroup, make_impala_learner, vtrace
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentCartPole,
    MultiAgentEnvRunner,
    MultiAgentPPOConfig,
    MultiAgentVectorEnv,
    make_policy_learners,
)
from ray_tpu_torch.rllib.policy import TorchPolicy, apply_policy, init_policy_params
from ray_tpu_torch.rllib.ppo import PPOConfig
from ray_tpu_torch.rllib.rl_module import ContinuousMLPModule, MLPModule, RLModule
from ray_tpu_torch.rllib.sac import ContinuousReplayBuffer, SACConfig, make_sac_learner
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae

__all__ = [
    "APPOConfig",
    "CartPoleVectorEnv",
    "ContinuousMLPModule",
    "ContinuousReplayBuffer",
    "DQNConfig",
    "EnvRunner",
    "IMPALAConfig",
    "LearnerGroup",
    "MLPModule",
    "MultiAgentCartPole",
    "MultiAgentEnvRunner",
    "MultiAgentPPOConfig",
    "MultiAgentVectorEnv",
    "PPOConfig",
    "PendulumVectorEnv",
    "RLModule",
    "ReplayBuffer",
    "SACConfig",
    "SampleBatch",
    "TorchPolicy",
    "VectorEnv",
    "apply_policy",
    "compute_gae",
    "init_policy_params",
    "make_appo_learner",
    "make_impala_learner",
    "make_policy_learners",
    "make_sac_learner",
    "make_vector_env",
    "register_env",
    "vtrace",
]
