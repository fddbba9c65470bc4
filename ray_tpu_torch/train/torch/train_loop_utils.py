"""prepare_model / prepare_data_loader for torch train loops.

ray: python/ray/train/torch/train_loop_utils.py:92-98 (DDP/FSDP wrap) —
reduced to the CPU/gloo case this backend targets: DDP wrap + a
DistributedSampler-equipped loader.
"""

from __future__ import annotations


def prepare_model(model, parallel_strategy: str = "ddp"):
    """Move an nn.Module to this worker's device and wrap it for distributed
    training (ray: prepare_model :92-98). The device is the card the
    backend bound, cuda:0 of a worker that holds one (its
    CUDA_VISIBLE_DEVICES names the card of its id), else the CPU; with more
    than one rank the module is wrapped in DDP, over that card."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel as DDP

    import ray_tpu_torch

    if parallel_strategy not in ("ddp", None):
        raise ValueError(
            f"parallel_strategy {parallel_strategy!r} unsupported here: the port "
            "wraps in DDP (the decoder's sharded step is LMTrainContext)"
        )
    on_card = bool(ray_tpu_torch.get_gpu_ids()) and torch.cuda.is_available()
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    model = model.to(device)
    if dist.is_initialized() and dist.get_world_size() > 1 and parallel_strategy:
        return DDP(model, device_ids=[device.index] if on_card else None)
    return model


def prepare_data_loader(dataset, batch_size: int, shuffle: bool = True):
    """DataLoader with a per-rank DistributedSampler
    (ray: prepare_data_loader)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    sampler = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        sampler = DistributedSampler(dataset, shuffle=shuffle)
        shuffle = False
    return DataLoader(
        dataset, batch_size=batch_size, shuffle=shuffle, sampler=sampler
    )
