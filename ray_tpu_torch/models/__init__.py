"""ray_tpu_torch.models: the port's model families (the Llama-family
decoder: its forward and its training step, on one device or sharded over a
mesh, pipelined too; the MoE block, plain or expert-parallel), and the
optimizers (`default_optimizer`, and `adam` for the RL learners)."""

from ray_tpu_torch.models.convert import (
    learner_state_from_numpy,
    params_from_numpy,
    state_from_numpy,
)
from ray_tpu_torch.models.lm import LMTrainContext, adam, cross_entropy_loss, default_optimizer
from ray_tpu_torch.models.moe import MoEConfig, init_moe_params, moe_ffn, moe_param_axes
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    param_axes,
    param_shapes,
)

__all__ = [
    "LMTrainContext",
    "MoEConfig",
    "TransformerConfig",
    "adam",
    "cross_entropy_loss",
    "default_optimizer",
    "forward",
    "init_moe_params",
    "init_params",
    "learner_state_from_numpy",
    "moe_ffn",
    "moe_param_axes",
    "param_axes",
    "param_shapes",
    "params_from_numpy",
    "state_from_numpy",
]
