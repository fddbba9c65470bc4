"""ray_tpu_torch.parallel: meshes, sharding rules, collectives (the host
`CollectiveGroup` over the runtime, and collectives on device tensors) and
the pipeline schedules (GPipe, 1F1B), port of `ray_tpu/parallel/`.

The JAX package's `tree_shardings` becomes `local_placements` (which mesh
axes split each dim of each leaf); `with_logical_constraint`, a hint to
XLA's partitioner, has no counterpart: the sharded forward issues its
collectives itself (`models/transformer.py`).
"""

from ray_tpu_torch.parallel.bootstrap import (
    MeshBootstrap,
    pick_coordinator_address,
    setup_mesh,
)
from ray_tpu_torch.parallel.collectives import (
    CollectiveGroup,
    allgather,
    allreduce,
    barrier,
    broadcast,
    copy_to,
    destroy_collective_group,
    device_allreduce,
    gather_from,
    gather_shards,
    get_group,
    init_collective_group,
    recv,
    reduce_from,
    reducescatter,
    send,
)
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshSpec,
    build_mesh,
    mesh_axis_sizes,
    remesh_spec,
    single_device_mesh,
)
from ray_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_train_step_1f1b
from ray_tpu_torch.parallel.sharding import (
    PRESETS,
    Rules,
    gather_tree,
    local_placements,
    logical_to_spec,
    resolve_rules,
    shard_tree,
)

__all__ = [
    "AXIS_ORDER",
    "CollectiveGroup",
    "MeshBootstrap",
    "MeshSpec",
    "PRESETS",
    "Rules",
    "allgather",
    "allreduce",
    "barrier",
    "broadcast",
    "build_mesh",
    "copy_to",
    "destroy_collective_group",
    "device_allreduce",
    "gather_from",
    "gather_shards",
    "gather_tree",
    "get_group",
    "init_collective_group",
    "local_placements",
    "logical_to_spec",
    "mesh_axis_sizes",
    "pick_coordinator_address",
    "pipeline_apply",
    "pipeline_train_step_1f1b",
    "recv",
    "reduce_from",
    "reducescatter",
    "remesh_spec",
    "resolve_rules",
    "send",
    "setup_mesh",
    "shard_tree",
    "single_device_mesh",
]
