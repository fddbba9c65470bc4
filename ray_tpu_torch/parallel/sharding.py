"""Logical-axis sharding rules, port of `ray_tpu/parallel/sharding.py`.

A strategy is a table mapping logical array axes ("embed", "mlp", "heads",
"act_batch", ...) to mesh axes: switching DP → FSDP → TP → SP is a rules
change, no model code change. The tables are the JAX package's, as data.

In the JAX package XLA partitions global arrays by these rules and inserts
the collectives. The port holds on every rank only its shard of each
array, as plain tensors: `shard_tree` cuts a rank's shards out of a full
tree, `gather_tree` puts the full tree back together, and
`local_placements` records per leaf which mesh axes split which dim, which
the model's forward and the training step read to place their collectives.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import mesh_axis_sizes

MeshAxis = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxis]
# Per dim of a tensor, the mesh axes (of size > 1) that split it, outermost
# first: () for a dim every rank holds whole.
Placement = Tuple[Tuple[str, ...], ...]

# Logical axis vocabulary used by models/ (see models/transformer.py).
# Parameter axes and activation axes are distinct namespaces (act_*): under
# FSDP, params shard their embed dim over `fsdp` while activations shard
# batch over ("data", "fsdp") — same mesh axis, different logical axes, so
# a single rules table can't alias them.
#
#   embed/heads/kv_heads/head_dim/mlp/vocab/expert — parameter dims
#   layers — the stacked layers' leading axis (sharded over `pipeline` by
#            pp_rules; unsharded elsewhere)
#   act_batch/act_seq/act_embed/act_heads/act_kv_heads/act_head_dim/
#   act_mlp/act_vocab — activation dims

_BASE: Rules = {
    # params
    "embed": None,
    "heads": None,
    "kv_heads": None,
    "head_dim": None,
    "mlp": None,
    "vocab": None,
    "expert": None,
    "layers": None,
    # activations
    "act_batch": ("data", "fsdp"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": None,
    "act_kv_heads": None,
    "act_head_dim": None,
    "act_mlp": None,
    "act_vocab": None,
    "act_expert": None,
}


def dp_rules() -> Rules:
    """Pure data parallel: replicate params, shard batch."""
    return dict(_BASE)


def fsdp_rules() -> Rules:
    """ZeRO-3 analogue: shard every large param dim over the fsdp axis; the
    forward all-gathers each layer's weights where it uses them and the
    backward reduce-scatters their gradients."""
    r = dict(_BASE)
    r.update(embed="fsdp", mlp=None, vocab=None)
    return r


def tp_rules() -> Rules:
    """Megatron-style tensor parallel over the tensor axis."""
    r = dict(_BASE)
    r.update(
        heads="tensor", kv_heads="tensor", mlp="tensor", vocab="tensor",
        act_heads="tensor", act_kv_heads="tensor", act_mlp="tensor",
        act_vocab="tensor",
    )
    return r


def fsdp_tp_rules() -> Rules:
    """2D: params sharded over fsdp × tensor."""
    r = tp_rules()
    r.update(embed="fsdp")
    return r


def sp_rules() -> Rules:
    """Context/sequence parallel: shard activations along seq (ring attention
    pairs with this — ops/ring_attention.py)."""
    r = fsdp_tp_rules()
    r.update(act_seq="seq")
    return r


def pp_rules() -> Rules:
    """Pipeline parallel: the layer stack shards over the `pipeline` axis."""
    r = dict(_BASE)
    r.update(layers="pipeline")
    return r


def pp_fsdp_rules() -> Rules:
    """Pipeline x FSDP: layer stack over `pipeline`, params-at-rest sharded
    over `fsdp` within each stage."""
    r = dict(_BASE)
    r.update(layers="pipeline", embed="fsdp")
    return r


def ep_rules() -> Rules:
    """Expert parallel for MoE layers."""
    r = fsdp_tp_rules()
    r.update(expert="expert", act_expert="expert")
    return r


PRESETS = {
    "dp": dp_rules,
    "fsdp": fsdp_rules,
    "tp": tp_rules,
    "fsdp_tp": fsdp_tp_rules,
    "sp": sp_rules,
    "pp": pp_rules,
    "pp_fsdp": pp_fsdp_rules,
    "ep": ep_rules,
}


def resolve_rules(strategy: Union[str, Rules]) -> Rules:
    if isinstance(strategy, str):
        try:
            return PRESETS[strategy]()
        except KeyError:
            raise ValueError(f"unknown strategy {strategy!r}; options {sorted(PRESETS)}")
    return dict(strategy)


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: Rules) -> Tuple[MeshAxis, ...]:
    """Map a tuple of logical axis names (None = unsharded) to a spec: one
    entry per dim, None, a mesh axis or a tuple of them (the entries of the
    JAX package's PartitionSpec)."""
    return tuple(rules.get(a) if a is not None else None for a in logical_axes)


def _fit_spec(shape, spec: Sequence[MeshAxis], sizes: Mapping[str, int]) -> Tuple[MeshAxis, ...]:
    """Drop mesh axes (innermost first) from any spec entry whose axis-size
    product does not divide the corresponding dim. Replicates instead of
    erroring for e.g. GQA kv_heads < tensor-axis size. `sizes` maps each
    mesh axis to its size (`mesh_axis_sizes`)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    new_entries = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            new_entries.append(None)
            continue
        axes = list(entry) if isinstance(entry, tuple) else [entry]
        while axes and dim % math.prod(sizes[a] for a in axes) != 0:
            axes.pop()
        new_entries.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(new_entries)


def placement(shape, logical_axes, rules: Rules, sizes: Mapping[str, int]) -> Placement:
    """The mesh axes that split each dim of a tensor of `shape` whose dims
    are `logical_axes`, fitted to the shape (`_fit_spec`); axes of size 1
    split nothing and are left out."""
    spec = _fit_spec(shape, logical_to_spec(logical_axes, rules), sizes)
    return tuple(
        tuple(a for a in ((e,) if isinstance(e, str) else (e or ())) if sizes[a] > 1)
        for e in spec
    )


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of nested dicts and lists (anything else is a
    leaf: a tuple too, as a `Placement` is), with the congruent leaves of
    `rest`, looked up by key or index."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, in insertion order (the order
    `tree_map` visits them)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def local_placements(shapes, axes_tree, rules: Rules, mesh) -> Dict[str, Any]:
    """Tree of `Placement`s, congruent with `axes_tree` (logical axes per
    leaf, `param_axes`), for leaves of the full `shapes`."""
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda shape, axes: placement(tuple(shape), axes, rules, sizes),
                    shapes, axes_tree)


def shard_index(axes: Sequence[str], mesh) -> Tuple[int, int]:
    """(this rank's index among the shards of a dim split over `axes`, the
    number of shards): the first axis is the major one, as in a
    PartitionSpec entry of several axes."""
    sizes = mesh_axis_sizes(mesh)
    index, count = 0, 1
    for a in axes:
        n = sizes[a]
        index, count = index * n + mesh.get_local_rank(a), count * n
    return index, count


def shard_tensor(x: torch.Tensor, place: Placement, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor `x`, a copy of its own (`x`
    itself where nothing splits it). Raises where a dim does not divide."""
    shard = x
    for dim, axes in enumerate(place):
        if not axes:
            continue
        index, count = shard_index(axes, mesh)
        if x.shape[dim] % count:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} does not divide over mesh axes {axes} ({count})"
            )
        size = x.shape[dim] // count
        shard = shard.narrow(dim, index * size, size)
    return shard if shard is x else shard.clone()


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The tensors of every rank of `group` concatenated along `dim`, in
    group-rank order (no autograd)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    # The tensor form's name varies across torch versions.
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def gather_tensor(x: torch.Tensor, place: Placement, mesh) -> torch.Tensor:
    """The full tensor from every rank's shard `x`: the inverse of
    `shard_tensor` (a collective: every rank of the mesh calls it; no
    autograd)."""
    x = x.detach()
    for dim, axes in enumerate(place):
        for a in reversed(axes):  # the minor axis first
            x = all_gather_dim(x, mesh.get_group(a), dim)
    return x


def shard_tree(full_tree, axes_tree, rules: Rules, mesh):
    """Every rank cuts its shards out of the same full tree (nested dicts of
    tensors, with logical axes `axes_tree`): leaves nothing splits are kept
    as they are, the others copied."""
    places = local_placements(tree_map(lambda t: t.shape, full_tree), axes_tree, rules, mesh)
    return tree_map(lambda t, p: shard_tensor(t, p, mesh), full_tree, places)


def gather_tree(local_tree, placements, mesh):
    """The full tree from every rank's shards (`local_placements` of the
    full tree): the inverse of `shard_tree`, a collective."""
    return tree_map(lambda t, p: gather_tensor(t, p, mesh), local_tree, placements)
