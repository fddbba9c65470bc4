"""Train backends: per-framework worker-group setup.

ray: python/ray/train/backend.py (Backend/BackendConfig) and
train/torch/config.py:69 (_setup_torch_process_group — rank-0 address
broadcast, then dist.init_process_group :113).  Port of
`ray_tpu/train/backend.py`, where JaxConfig joins the workers through
jax.distributed: TorchConfig's on_start picks a coordinator on rank 0 and
every worker joins one torch.distributed process group, NCCL with each
worker bound to its card or gloo on CPU workers.  The train loop then
builds its mesh over that group (`ray_tpu_torch.parallel.build_mesh`).
"""

from __future__ import annotations

import dataclasses
import datetime

from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.parallel.mesh import BACKENDS
from ray_tpu_torch.train.worker_group import WorkerGroup

# How long a worker waits for its peers to join the group, and a collective
# for its peers, before it raises.
_TIMEOUT = datetime.timedelta(seconds=120)
# How long rank 0's first call waits, its placement included, before the
# trainer fails: a worker whose card another trainer's worker holds (tune's
# trials on one card take it in turn) waits for that trainer to end.
_PLACEMENT_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class BackendConfig:
    """Base backend config (ray: python/ray/train/backend.py)."""

    def backend_cls(self):
        return Backend


class Backend:
    """Framework setup/teardown hooks around a WorkerGroup."""

    def on_start(self, worker_group: WorkerGroup, backend_config: "BackendConfig"):
        pass

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: "BackendConfig"):
        pass


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """Process-group bootstrap over the worker group.

    coordinator_port 0 = pick a free port on rank 0's host.
    device: "cuda" (each worker reserves a whole "GPU", binds the card the
    runtime gave it, whose id `ray_tpu_torch.get_gpu_ids()` reads and which
    its CUDA_VISIBLE_DEVICES names, and joins an NCCL group; a worker that
    holds no whole card, or sees none, raises) or "cpu" (gloo).
    """

    coordinator_port: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.device not in BACKENDS:
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")

    def backend_cls(self):
        return _TorchBackend

    def scaling(self, scaling_config: ScalingConfig) -> ScalingConfig:
        """The scaling config with a "GPU" reserved for each worker that
        binds a card, so that the scheduler places no more such workers on
        a host than it has cards, and nothing else on a card they hold."""
        if self.device == "cuda" and not scaling_config.worker_resources().get("GPU"):
            return dataclasses.replace(scaling_config, use_gpu=True)
        return scaling_config


def _pick_coordinator(port: int) -> str:
    from ray_tpu_torch.parallel.bootstrap import pick_coordinator_address

    return pick_coordinator_address(port)


def _init_torch_distributed(coordinator: str, world_size: int, rank: int, device: str):
    import torch
    import torch.distributed as dist

    import ray_tpu_torch

    gpu_ids = ray_tpu_torch.get_gpu_ids()
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"TorchConfig(device='cuda'): train worker {rank} sees no CUDA card; "
                "pass TorchConfig(device='cpu') for CPU workers"
            )
        if not gpu_ids:
            raise RuntimeError(
                f"TorchConfig(device='cuda'): train worker {rank} holds no whole \"GPU\"; "
                "an NCCL rank needs a card of its own"
            )
        # The worker's CUDA_VISIBLE_DEVICES names the cards of its ids: the
        # first is its cuda:0.
        torch.cuda.set_device(0)
    if world_size > 1:
        dist.init_process_group(
            BACKENDS[device],
            init_method=f"tcp://{coordinator}",
            world_size=world_size,
            rank=rank,
            timeout=_TIMEOUT,
        )
    return {"rank": rank, "world_size": world_size, "device": device, "gpu_ids": gpu_ids}


def _destroy_process_group():
    import sys

    # A worker that never imported torch.distributed holds no group.
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup, backend_config: TorchConfig):
        coordinator = worker_group.execute_single(
            0, _pick_coordinator, backend_config.coordinator_port,
            timeout=_PLACEMENT_TIMEOUT.total_seconds(),
        )
        # All workers join the group (the reference broadcasts rank-0's
        # addr, then every rank calls init_process_group).
        return self._start_all(worker_group, coordinator, backend_config)

    @staticmethod
    def _start_all(worker_group: WorkerGroup, coordinator: str, cfg: TorchConfig):
        import ray_tpu_torch

        n = worker_group.num_workers
        # Concurrently: init_process_group blocks until every rank arrives.
        refs = [
            w.run_fn.remote(_init_torch_distributed, coordinator, n, i, cfg.device)
            for i, w in enumerate(worker_group.workers)
        ]
        return ray_tpu_torch.get(refs, timeout=_TIMEOUT.total_seconds() + 30)

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: TorchConfig):
        try:
            worker_group.execute(_destroy_process_group, timeout=30)
        except Exception:
            pass
