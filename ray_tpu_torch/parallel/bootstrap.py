"""Mesh bootstrap, port of `ray_tpu/parallel/bootstrap.py`: get N
processes, one per device, into one process group.

In the JAX package every host calls `jax.distributed.initialize` and one
SPMD program then spans the slice. The port's ranks join a
`torch.distributed` process group instead: NCCL with each rank bound to
its card, or gloo for CPU processes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import BACKENDS, MeshSpec, build_mesh, resolve_device_type

# How long a collective waits for its peers before it raises.
_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass
class MeshBootstrap:
    """Per-process description of how to join the global mesh."""

    num_processes: int = 1
    process_id: int = 0
    coordinator_address: Optional[str] = None  # "host:port", required if >1 proc
    local_device_ids: Optional[list] = None  # this process's card (first entry)
    device_type: Optional[str] = None  # "cuda" (default) or "cpu"

    def initialize(self):
        """Join the process group. Idempotent; no-op single-process (the
        first `build_mesh` makes a one-rank group)."""
        if self.num_processes <= 1 or dist.is_initialized():
            return
        if not self.coordinator_address:
            raise ValueError(f"{self.num_processes} processes need a coordinator_address")
        device_type = resolve_device_type(self.device_type)
        if device_type == "cuda":
            local = (self.local_device_ids or [self.process_id % torch.cuda.device_count()])[0]
            torch.cuda.set_device(local)
        dist.init_process_group(
            BACKENDS[device_type],
            init_method=f"tcp://{self.coordinator_address}",
            world_size=self.num_processes,
            rank=self.process_id,
            timeout=_TIMEOUT,
        )

    def shutdown(self):
        """Leave the process group so this process can rejoin a re-meshed
        gang. Safe to call when initialize() never ran or the group is
        already gone."""
        if self.num_processes <= 1 or not dist.is_initialized():
            return
        try:
            dist.destroy_process_group()
        except (RuntimeError, ValueError):
            pass  # the group's store or peers are already gone


def pick_coordinator_address(port: int = 0) -> str:
    """Choose a reachable coordinator address on this host (rank-0 side)."""
    host = os.environ.get("RAY_TPU_HOST_IP") or socket.gethostbyname(socket.gethostname())
    if port == 0:
        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
    return f"{host}:{port}"


def setup_mesh(
    spec: Optional[MeshSpec] = None,
    bootstrap: Optional[MeshBootstrap] = None,
    *,
    device_type: Optional[str] = None,
):
    """Join the (maybe multi-process) group and build the mesh."""
    if bootstrap is not None:
        bootstrap.initialize()
        device_type = device_type or bootstrap.device_type
    return build_mesh(spec, device_type=device_type)
