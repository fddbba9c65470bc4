"""ray_tpu_torch.air: shared ML plumbing, port of `ray_tpu/air/` (the
Checkpoint so far; the rest comes with the trainer, ROADMAP A7/A14)."""

from ray_tpu_torch.air.checkpoint import Checkpoint

__all__ = ["Checkpoint"]
