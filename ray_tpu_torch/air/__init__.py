"""ray_tpu_torch.air: shared ML plumbing (ray: python/ray/air/)."""

from ray_tpu_torch.air.batch_predictor import BatchPredictor, Predictor
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air import preprocessors
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train import session

__all__ = [
    "BatchPredictor",
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "Predictor",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "preprocessors",
    "session",
]
