"""ray_tpu_torch.models: the port's model families (the Llama-family
decoder: its forward and its training step, on one device or sharded over a
mesh)."""

from ray_tpu_torch.models.convert import params_from_numpy, state_from_numpy
from ray_tpu_torch.models.lm import LMTrainContext, cross_entropy_loss, default_optimizer
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    param_axes,
    param_shapes,
)

__all__ = [
    "LMTrainContext",
    "TransformerConfig",
    "cross_entropy_loss",
    "default_optimizer",
    "forward",
    "init_params",
    "param_axes",
    "param_shapes",
    "params_from_numpy",
    "state_from_numpy",
]
