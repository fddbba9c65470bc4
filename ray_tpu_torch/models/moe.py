"""Mixture-of-Experts block, port of `ray_tpu/models/moe.py`: top-k routing
with per-expert capacity and the dense one-hot dispatch and combine.

Dense-compute formulation (einsums over a one-hot dispatch mask rather
than a ragged gather): identical math to token-dropping MoE with capacity,
and every op a static-shape product.

Under sharding rules and a mesh (`ep_rules`: experts over the `expert`
axis, `embed` over `fsdp`, `mlp` over `tensor`) each rank calls
`moe_ffn` with its shards of the parameters (`shard_tree` by
`moe_param_axes`) and its tokens (the batch over act_batch's axes) and
issues the collectives that XLA inserts for the JAX package, which runs
the function on the global batch:

- the routing is global: the capacity comes from the global token count,
  a token's place in an expert's queue counts the tokens of the ranks
  before it in the global order (an exclusive prefix of the per-expert
  counts over the batch axes), and the aux loss takes global means;
- each rank computes its E/ep experts, with their `mlp` dim split over the
  tensor axis (column-parallel w_gate/w_up, row-parallel w_down), on the
  capacity slots its own tokens fill: an expert's rows are independent, so
  the slots of other ranks' tokens need not travel (where XLA's
  partitioner moves them), and the output rows of a token sum over the
  expert and tensor ranks;
- the weights' `embed` dims are all-gathered over their batch axes
  (fsdp), whose backward reduce-scatters the gradients; the router's
  expert dim is all-gathered over the expert axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.parallel.collectives import copy_to, gather_from, gather_shards, reduce_from
from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
from ray_tpu_torch.parallel.sharding import (
    Rules,
    gather_tensor,
    local_placements,
    shard_index,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_model: int = 64
    d_ff: int = 128
    # tokens each expert processes per batch = capacity_factor * T * k / E
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance loss weight (Switch-style)


def moe_param_axes(cfg: MoEConfig) -> Dict:
    return {
        "router": ("embed", "expert"),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


def moe_param_shapes(cfg: MoEConfig) -> Dict:
    """The full parameter shapes, congruent with `moe_param_axes`."""
    size = {"embed": cfg.d_model, "expert": cfg.n_experts, "mlp": cfg.d_ff}
    return tree_map(lambda axes: tuple(size[a] for a in axes), moe_param_axes(cfg))


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, *, device=None,
                    dtype=torch.float32) -> Dict:
    """The JAX package's tree and scale, drawn as plain normal * scale from
    `generator`, which must live on `device` (the card unless device="cpu"
    is passed). Carry weights over with `params_from_numpy` where they must
    agree with the JAX package's."""
    from ray_tpu_torch.models.transformer import _resolve_device

    device = _resolve_device(device)
    scale = cfg.d_model ** -0.5

    def draw(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (x * scale).to(dtype)

    return tree_map(draw, moe_param_shapes(cfg))


@dataclasses.dataclass(frozen=True)
class _MoESharded:
    """What `moe_ffn` under (rules, mesh) reads, for this rank: the batch
    axes (act_batch's, size > 1) and this rank's index among their shards;
    per leaf the (dim, group) of each all-gather (`gather_shards` over batch
    axes, `gather_from` over the expert axes for the router); the groups
    the output rows sum over (expert and tensor); this rank's first expert
    and its count."""

    mesh: object
    batch_axes: Tuple[str, ...]
    batch_index: int
    batch_count: int
    gathers: Dict
    partial: Tuple[object, ...]
    first_expert: int
    n_local: int


def _moe_plan(cfg: MoEConfig, rules: Rules, mesh) -> _MoESharded:
    sizes = mesh_axis_sizes(mesh)
    axes = lambda entry: (entry,) if isinstance(entry, str) else tuple(entry or ())  # noqa: E731
    batch_axes = tuple(a for a in axes(rules.get("act_batch")) if sizes.get(a, 1) > 1)
    places = local_placements(moe_param_shapes(cfg), moe_param_axes(cfg), rules, mesh)
    expert_axes = places["w_gate"][0]
    mlp_axes = places["w_gate"][2]
    if set(expert_axes) & set(batch_axes):
        raise NotImplementedError(f"experts split over the batch axes {expert_axes}: the port "
                                  "keeps a rank's tokens on the ranks of its experts' axis")
    if mlp_axes and tuple(a for a in axes(rules.get("act_mlp")) if sizes.get(a, 1) > 1) != mlp_axes:
        raise NotImplementedError(f"the experts' mlp dim split over {mlp_axes} must be "
                                  "tensor-parallel (act_mlp over the same axes)")

    def plan(place, logical):
        gathers = []
        for dim, (split, name) in enumerate(zip(place, logical)):
            if name == "expert" and logical != ("embed", "expert"):
                continue  # each rank holds its experts
            if name == "mlp":
                continue  # tensor-parallel
            if name == "expert":  # the router's: every rank routes to every expert
                gathers += [(dim, mesh.get_group(a), gather_from) for a in reversed(split)]
                continue
            if not set(split) <= set(batch_axes):
                raise NotImplementedError(f"{name!r} split over {split}: only the batch axes "
                                          f"{batch_axes} can sum the ranks' gradients")
            gathers += [(dim, mesh.get_group(a), gather_shards) for a in reversed(split)]
        return tuple(gathers)

    index, count = shard_index(batch_axes, mesh)
    e_index, e_count = shard_index(expert_axes, mesh)
    n_local = cfg.n_experts // e_count
    return _MoESharded(
        mesh=mesh, batch_axes=batch_axes, batch_index=index, batch_count=count,
        gathers=tree_map(plan, places, moe_param_axes(cfg)),
        partial=tuple(mesh.get_group(a) for a in expert_axes + mlp_axes),
        first_expert=e_index * n_local, n_local=n_local,
    )


_PLANS: Dict[tuple, _MoESharded] = {}


def _sharded(cfg: MoEConfig, rules: Rules, mesh) -> _MoESharded:
    """The plan of `moe_ffn` under (rules, mesh), built once (see
    `models/transformer.py:_sharded`)."""
    key = (cfg, tuple(sorted((k, str(v)) for k, v in rules.items())), id(mesh))
    if key not in _PLANS:
        _PLANS[key] = _moe_plan(cfg, rules, mesh)
    return _PLANS[key]


def _sum_over(x: torch.Tensor, sh: _MoESharded) -> torch.Tensor:
    """`x` summed over the batch axes, with the identity as its backward:
    every rank's downstream (the aux loss) is the same."""
    for a in sh.batch_axes:
        x = reduce_from(x, sh.mesh.get_group(a))
    return x


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for `n_tokens` (global) tokens."""
    return max(int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts), cfg.top_k)


def _route(tokens: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, capacity: int,
           sh: Optional[_MoESharded] = None):
    """Top-k routing of tokens [T, D] with capacity: (probs f32 [T, E],
    normalised gates [T, K], the kept one-hot choices f32 [T, K, E], each
    choice's position in its expert's queue [T, K, E])."""
    E, K = cfg.n_experts, cfg.top_k
    T_local = tokens.shape[0]
    logits = tokens @ router  # [T, E]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)

    # Top-k expert choice per token.
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)  # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Capacity: position of each token within its chosen expert's queue, in
    # the global token order; tokens past capacity drop (Switch behaviour).
    onehot = torch.nn.functional.one_hot(expert_idx, E).to(torch.float32)  # [T, K, E]
    position = torch.cumsum(onehot.reshape(T_local * K, E), dim=0).reshape(T_local, K, E) - 1.0
    if sh is not None and sh.batch_count > 1:
        counts = onehot.sum(dim=(0, 1))[None]  # [1, E]
        every = gather_tensor(counts, (sh.batch_axes, ()), sh.mesh)  # [ranks, E], batch order
        position = position + every[:sh.batch_index].sum(dim=0)
    return probs, gate_vals, onehot * (position < capacity), position


def moe_ffn(
    params: Dict,
    x: torch.Tensor,
    cfg: MoEConfig,
    *,
    rules: Optional[Rules] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar f32).

    Dispatch: top-k router over the f32 softmax -> per-expert
    capacity-limited one-hot combine tensor -> einsum dispatch, SwiGLU
    experts, combine. Under `rules` and a `mesh` (given together) every rank
    passes its shards and its slice of the batch and gets its slice of y and
    the global aux loss (see the module docstring)."""
    if (rules is None) != (mesh is None):
        raise ValueError("sharding rules and a mesh go together: the port takes its mesh "
                         "explicitly, with no ambient mesh scope")
    sh = None if rules is None else _sharded(cfg, rules, mesh)
    B, S, D = x.shape
    E = cfg.n_experts
    T_local = B * S
    T = T_local * (sh.batch_count if sh is not None else 1)  # the global token count
    capacity = _capacity(cfg, T)
    dt = x.dtype

    def weight(name):
        w = params[name]
        if sh is not None:
            for dim, group, gather in sh.gathers[name]:
                w = gather(w, group, dim)
        return w.to(dt)

    tokens = x.reshape(T_local, D)
    probs, gate_vals, onehot, position = _route(tokens, weight("router"), cfg, capacity, sh)

    # combine [T, E, C]: weight of each token at its slot in each expert.
    pos = torch.einsum("tke,tke->tk", position, onehot).to(torch.int64)
    slot_onehot = torch.nn.functional.one_hot(pos, capacity).to(torch.float32)  # [T, K, C]
    gates = gate_vals
    if sh is not None:
        for group in sh.partial:  # this rank's experts give a partial gradient
            gates, tokens = copy_to(gates, group), copy_to(tokens, group)
    combine = torch.einsum("tk,tke,tkc->tec", gates.to(torch.float32), onehot, slot_onehot)
    if sh is not None:
        combine = combine[:, sh.first_expert:sh.first_expert + sh.n_local]
    dispatch = (combine > 0).to(dt)  # [T, E, C]

    # Expert compute: [E, C, D] batched products.
    expert_in = torch.einsum("td,tec->ecd", tokens, dispatch)
    g = torch.einsum("ecd,edf->ecf", expert_in, weight("w_gate"))
    u = torch.einsum("ecd,edf->ecf", expert_in, weight("w_up"))
    h = torch.nn.functional.silu(g) * u
    expert_out = torch.einsum("ecf,efd->ecd", h, weight("w_down"))
    y = torch.einsum("ecd,tec->td", expert_out, combine.to(dt))
    if sh is not None:
        for group in sh.partial:
            y = reduce_from(y, group)

    # Switch load-balance aux loss: E * sum_e(frac_tokens_e * frac_probs_e).
    top1, prob_sum = onehot[:, 0, :].sum(dim=0), probs.sum(dim=0)  # top-1 assignment share
    if sh is not None:
        top1, prob_sum = _sum_over(top1, sh), _sum_over(prob_sum, sh)
    aux = cfg.router_aux_coef * E * torch.sum((top1 / T) * (prob_sum / T))
    return y.reshape(B, S, D).to(dt), aux
