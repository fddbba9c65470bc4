"""ray_tpu_torch.train.torch — torch DDP training on the actor runtime.

ray: python/ray/train/torch/ (TorchTrainer, config.py:69
_setup_torch_process_group, train_loop_utils.py prepare_model).  JAX is the
TPU compute path; this backend exists for reference-parity — users porting
TorchTrainer workloads get the same surface, running torch.distributed
with the gloo backend across the SPMD worker group.
"""

from ray_tpu_torch.train.torch.config import TorchConfig
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer
from ray_tpu_torch.train.torch.train_loop_utils import prepare_data_loader, prepare_model

__all__ = ["TorchConfig", "TorchTrainer", "prepare_data_loader", "prepare_model"]
