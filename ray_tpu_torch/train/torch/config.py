"""Torch backend config: the port's one `TorchConfig`.

ray: python/ray/train/torch/config.py (TorchConfig, _TorchBackend).  The JAX
package defines a second, gloo-only TorchConfig here beside its JaxConfig;
the port's backend is torch.distributed already (`ray_tpu_torch.train.backend`),
so this module names that one. Its `device` takes the place of the
source's `backend`: `TorchConfig(device="cpu")` joins a gloo group where the
source writes `TorchConfig(backend="gloo")`, and the default, "cuda", binds
each worker to its card and joins an NCCL group.
"""

from ray_tpu_torch.train.backend import TorchConfig

__all__ = ["TorchConfig"]
