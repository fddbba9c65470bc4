"""Device meshes, port of `ray_tpu/parallel/mesh.py`.

In the JAX package one SPMD program spans every device of a
`jax.sharding.Mesh`, and XLA compiles the collectives into it. The port
runs one process per device, a rank of a `torch.distributed` process group,
and describes the mesh with a `torch.distributed.device_mesh.DeviceMesh`
over the canonical axes: each mesh dimension has a process group, which
carries the collectives that the forward and the training step issue
themselves (`ray_tpu_torch.parallel.collectives`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Canonical logical axis order, as in the JAX package: "tensor" and "seq"
# innermost, so that on a host's cards they fall on neighbouring ranks;
# "data" outermost, the axis replicas may span hosts on.
AXIS_ORDER: Tuple[str, ...] = ("data", "fsdp", "expert", "pipeline", "seq", "tensor")

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape over named parallelism axes.

    Sizes of -1 mean "absorb remaining devices" (at most one axis may be -1).
    Axes of size 1 are still materialized so sharding rules can always refer to
    every canonical axis name.
    """

    data: int = -1
    fsdp: int = 1
    expert: int = 1
    pipeline: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return MeshSpec(**sizes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    def shape(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    def size(self) -> int:
        return math.prod(s for s in self.shape() if s > 0)


def remesh_spec(spec: MeshSpec, n_devices: int) -> MeshSpec:
    """Re-resolve a mesh spec after an elastic re-mesh changed the device
    count (host lost → shrink, replacement host returned → grow).

    A spec with a -1 wildcard re-absorbs the new count directly.  A fully
    fixed spec re-shapes along its "data" axis (the axis that spans hosts —
    replicas are what a host-count change adds or removes; the other axes
    would change the program's communication pattern) and fails with an
    actionable error when that isn't possible.
    """
    sizes = {a: getattr(spec, a) for a in AXIS_ORDER}
    if any(s == -1 for s in sizes.values()):
        return spec.resolve(n_devices)
    other = math.prod(s for a, s in sizes.items() if a != "data")
    if other <= 0 or n_devices % other != 0:
        raise ValueError(
            f"cannot re-mesh {sizes} onto {n_devices} devices: the non-data "
            f"axes need a multiple of {other}; use data=-1 for elastic "
            "training or resize the gang to a compatible host count"
        )
    sizes["data"] = n_devices // other
    return MeshSpec(**sizes)


def resolve_device_type(device_type: Optional[str]) -> str:
    """`device_type`, or "cuda" when None. Meshes are of CUDA cards unless
    the caller asks for CPU processes: with no card and no device type this
    raises instead of quietly building a CPU mesh."""
    if device_type is not None:
        if device_type not in BACKENDS:
            raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, got {device_type!r}")
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' to build a mesh of "
            "CPU processes"
        )
    return "cuda"


def build_mesh(spec: Optional[MeshSpec] = None, *, device_type: Optional[str] = None) -> DeviceMesh:
    """Materialize a DeviceMesh from a MeshSpec, one rank per device.

    The mesh spans the ranks of the default process group, which
    `MeshBootstrap.initialize` (or the caller) has joined; ranks fill the
    mesh in row-major order over `AXIS_ORDER`, so the innermost axes
    ("tensor", "seq") pair neighbouring ranks. With no process group
    initialised, this process alone makes a one-rank group (NCCL on the
    card, gloo on the CPU) and the one-rank mesh. Every axis is a mesh
    dimension, size 1 included.
    """
    device_type = resolve_device_type(device_type)
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[device_type], store=dist.HashStore(), rank=0,
                                world_size=1)
    spec = (spec or MeshSpec()).resolve(dist.get_world_size())
    return init_device_mesh(device_type, spec.shape(), mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """The one-rank mesh of this process (its world must be one rank)."""
    return build_mesh(MeshSpec(data=1), device_type=device_type)


def mesh_axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
