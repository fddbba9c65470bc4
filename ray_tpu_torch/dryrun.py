"""The port's twin of the entry points of `__graft_entry__.py`: a
forward at a bench-scale configuration, and a multi-rank dry run that
composes every strategy.

entry(): the forward of the flagship decoder at `__graft_entry__.entry`'s
configuration, on the card unless the caller passes device="cpu".

dryrun_multichip(n): on n ranks, one sharded training step under fsdp_tp
(with a data axis), sp (ring attention), pp_fsdp, an expert-parallel MoE
block, the GPipe gradient and the 1F1B step, at tiny shapes; and the
accounting of one rank's training state for the 7B model under fsdp=8
against an H100's memory. Where no process group exists yet, it starts
the n ranks itself: one per card, or, with device_type="cpu", n CPU
processes joined in a gloo group (the JAX package's virtual CPU devices).
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.models.lm import LMTrainContext, _new_state, default_optimizer
from ray_tpu_torch.models.moe import MoEConfig, init_moe_params, moe_ffn, moe_param_axes
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _resolve_device,
    forward,
    init_params,
    param_axes,
    param_shapes,
)
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    BACKENDS,
    MeshSpec,
    build_mesh,
    mesh_axis_sizes,
    resolve_device_type,
)
from ray_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_train_step_1f1b
from ray_tpu_torch.parallel.sharding import (
    placement,
    resolve_rules,
    shard_tensor,
    shard_tree,
    tree_leaves,
    tree_map,
)

# `__graft_entry__.entry`'s configuration (`__graft_entry__.py:23-34`).
ENTRY_CONFIG = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8,
                    d_ff=2816, max_seq_len=1024, remat=False)
ENTRY_TOKENS = (4, 512)

# One H100's device memory, the bound of the 7B accounting.
H100_MEMORY_BYTES = 80e9
# How long a rank of a started dry run waits in a collective (the
# rendezvous included) before it gives up.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def entry(*, device=None, **overrides):
    """(fn, (params, tokens)): fn(params, tokens) is the decoder's forward
    at ENTRY_CONFIG (with `overrides`), params from a seeded generator,
    tokens zeros [4, 512]."""
    device = _resolve_device(device)
    cfg = TransformerConfig(**{**ENTRY_CONFIG, **overrides})
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    tokens = torch.zeros(ENTRY_TOKENS, dtype=torch.long, device=device)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def llama_7b_train_config() -> TransformerConfig:
    """The 7B training step's configuration in `__graft_entry__._dryrun_body`."""
    return TransformerConfig(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                             n_kv_heads=32, d_ff=11008, max_seq_len=2048, remat=True,
                             remat_policy="attn")


def state_bytes_per_rank(config: TransformerConfig, strategy: str,
                         spec: MeshSpec) -> Dict[str, int]:
    """Bytes of one rank's training state — parameters, gradients and the
    default optimizer's two moments — under `strategy` on a mesh of `spec`
    (every axis sized), counted from the leaves' local placements on meta
    tensors, so no memory is taken."""
    sizes = dict(zip(AXIS_ORDER, spec.shape()))
    rules = resolve_rules(strategy)

    def local(shape, axes):
        place = placement(tuple(shape), axes, rules, sizes)
        shard = [d // math.prod(sizes[a] for a in split) for d, split in zip(shape, place)]
        return torch.empty(shard, dtype=config.param_dtype, device="meta")

    params = tree_map(local, param_shapes(config), param_axes(config))
    state = _new_state(params, default_optimizer())
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    out = {"params": nbytes(tree_leaves(params)), "grads": nbytes(tree_leaves(params)),
           "moments": nbytes(state["opt_state"]["mu"]) + nbytes(state["opt_state"]["nu"])}
    out["total"] = sum(out.values())
    return out


def check_7b_state_fits() -> Dict[str, int]:
    """The 7B fsdp=8 step's per-rank state against one H100's memory;
    raises above it. Temporaries are not counted here (`PERF.md` adds those
    of one layer, measured on the card)."""
    counted = state_bytes_per_rank(llama_7b_train_config(), "fsdp", MeshSpec(data=1, fsdp=8))
    if counted["total"] > H100_MEMORY_BYTES:
        raise RuntimeError(f"7B fsdp step needs {counted['total'] / 1e9:.1f} GB a rank for its "
                           f"state > an H100's {H100_MEMORY_BYTES / 1e9:.0f} GB")
    return counted


def _step(cfg, mesh, strategy, batch) -> float:
    ctx = LMTrainContext(cfg, mesh, strategy)
    state = ctx.init_state(seed=0)
    _, metrics = ctx.train_step(state, batch)
    return float(metrics["loss"])  # waits for the step


def _dryrun_body(n_devices: int, device_type: str) -> None:
    n = dist.get_world_size()
    if n != n_devices:
        raise RuntimeError(f"requested {n_devices} ranks but the group has {n}")
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    mesh_of = lambda **spec: build_mesh(MeshSpec(**spec), device_type=device_type)  # noqa: E731

    # Real 2D+data sharding: fill the data axis after fixing fsdp/tensor.
    tensor = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % (tensor * 2) == 0 else 1
    cfg = TransformerConfig.tiny(n_heads=4, n_kv_heads=4, d_model=64, d_ff=128)
    toks = torch.zeros((8, 32), dtype=torch.long, device=device)
    batch = {"tokens": toks, "targets": toks}
    _step(cfg, mesh_of(data=-1, fsdp=fsdp, tensor=tensor), "fsdp_tp", batch)

    if n % 2 == 0:
        # Sequence parallelism: seq-split activations and ring attention.
        _step(cfg, mesh_of(data=-1, seq=4 if n % 4 == 0 else 2), "sp", batch)

        # Expert parallelism: the MoE block with its experts over `expert`.
        ep = 4 if n % 4 == 0 else 2
        ep_mesh = mesh_of(data=-1, expert=ep)
        moe_cfg = MoEConfig(n_experts=ep, top_k=2, d_model=64, d_ff=128)
        rules = resolve_rules("ep")
        full = init_moe_params(moe_cfg, gen(0), device=device)
        x = torch.randn((4, 16, 64), generator=gen(1), device=device)
        x_place = placement(x.shape, ("act_batch", None, None), rules, mesh_axis_sizes(ep_mesh))
        _, aux = moe_ffn(shard_tree(full, moe_param_axes(moe_cfg), rules, ep_mesh),
                         shard_tensor(x, x_place, ep_mesh), moe_cfg, rules=rules, mesh=ep_mesh)
        float(aux)

    if n % 4 == 0:
        # Pipeline x FSDP: the layer stack over `pipeline`, each stage's
        # weights over `fsdp` at rest, gathered once per step.
        _step(cfg, mesh_of(data=-1, fsdp=2, pipeline=2), "pp_fsdp", batch)

    # The 7B fsdp=8 state against an H100 (arithmetic on meta tensors).
    check_7b_state_fits()

    if n % 2 == 0:
        # GPipe over the pipeline axis (point-to-point stage hops), forward
        # and backward, then the 1F1B step on the same mesh.
        pp = 4 if n % 4 == 0 else 2
        pp_mesh = mesh_of(data=-1, pipeline=pp)
        sizes = mesh_axis_sizes(pp_mesh)
        w = torch.randn((pp, 32, 32), generator=gen(2), device=device) * 0.5
        stacked = {"w": shard_tensor(w, (("pipeline",), (), ()), pp_mesh).requires_grad_()}
        # 4 rows per data shard: every data size divides it, 2 microbatches fit.
        xb = torch.randn((sizes["data"] * 4, 32), generator=gen(3), device=device)
        tgt = torch.randn(xb.shape, generator=gen(4), device=device)
        rows = (("data",), ()) if sizes["data"] > 1 else ((), ())
        xb, tgt = shard_tensor(xb, rows, pp_mesh), shard_tensor(tgt, rows, pp_mesh)

        def stage(params, h):
            return torch.tanh(h @ params["w"])

        y = pipeline_apply(stage, stacked, xb, pp_mesh, n_microbatches=2)
        (g,) = torch.autograd.grad(torch.sum(y ** 2), [stacked["w"]])
        float(g.sum())
        loss, grads = pipeline_train_step_1f1b(
            stage, lambda yy, tt: torch.mean((yy - tt) ** 2), stacked, xb, tgt, pp_mesh,
            n_microbatches=2)
        float(loss)
        float(grads["w"].sum())


def _rank_main(rank: int, n_devices: int, device_type: str, init_file: str) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(BACKENDS[device_type], init_method=f"file://{init_file}", rank=rank,
                            world_size=n_devices, timeout=COLLECTIVE_TIMEOUT)
    try:
        _dryrun_body(n_devices, device_type)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, *, device_type: Optional[str] = None) -> None:
    """Run the dry run on `n_devices` ranks (see the module docstring).

    In a process group of n_devices ranks, every rank calls this and runs
    its part. Otherwise this starts the ranks: one per CUDA card, or n CPU
    processes with device_type="cpu", rendezvousing through a file in a
    temporary directory. It raises the first rank's failure, after which
    the other ranks are terminated; a rank left waiting on a failed one
    gives up after COLLECTIVE_TIMEOUT."""
    device_type = resolve_device_type(device_type)
    if dist.is_initialized():
        _dryrun_body(n_devices, device_type)
        return
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} CUDA cards, "
                           f"{torch.cuda.device_count()} visible; pass device_type='cpu' to run "
                           "them as CPU processes")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main, nprocs=n_devices,
                                    args=(n_devices, device_type, os.path.join(tmp, "rdzv")))
