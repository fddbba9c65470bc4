"""ray_tpu_torch.parallel: meshes, sharding rules, device collectives and
the pipeline schedules (GPipe, 1F1B), port of `ray_tpu/parallel/` (the host
`CollectiveGroup` comes with a later slice: ROADMAP A7/A14).

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
    copy_to,
    device_allreduce,
    gather_from,
    gather_shards,
    reduce_from,
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
    "MeshBootstrap",
    "MeshSpec",
    "PRESETS",
    "Rules",
    "build_mesh",
    "copy_to",
    "device_allreduce",
    "gather_from",
    "gather_shards",
    "gather_tree",
    "local_placements",
    "logical_to_spec",
    "mesh_axis_sizes",
    "pick_coordinator_address",
    "pipeline_apply",
    "pipeline_train_step_1f1b",
    "reduce_from",
    "remesh_spec",
    "resolve_rules",
    "setup_mesh",
    "shard_tree",
    "single_device_mesh",
]
