"""Flagship model: Llama-family decoder-only transformer, port of
`ray_tpu/models/transformer.py`.

- Parameters are a plain dict tree with the JAX package's names, shapes and
  layouts (no transposes): `wq` is [L, E, H, Dh], `wo` [L, H, Dh, E], the
  layers stacked on a leading [L] axis. `forward` loops over that axis where
  the JAX package runs `lax.scan`, on the views of one `unbind` of each
  stacked leaf, so the backward forms each leaf's gradient with one stack of
  its layers' slices.
- Rounding points follow the JAX package: the embedding table is cast to the
  compute dtype before the gather, each weight is cast to the compute dtype
  at its use, and the logits come out of a product in the compute dtype and
  are then cast to f32.
- Attention goes through `ray_tpu_torch.ops.attention.dot_product_attention`,
  which picks the hand-written flash kernel on a CUDA device when the shapes
  are tile-aligned.

- Remat (`config.remat`, `remat_policy`) wraps explicit segments of each
  layer in `torch.utils.checkpoint` when autograd records, so the tensors
  that live from the forward to the backward are those the JAX package's
  checkpoint policies save (`_remat_layer`).

- Under sharding rules and a mesh (`forward(..., rules=, mesh=)`) each rank
  runs the forward on its shards (`ray_tpu_torch.parallel.sharding`) and
  issues the collectives that XLA inserts for the JAX package at its
  sharding constraints: a per-use all-gather of fsdp-split weights inside
  the remat segment that uses them; Megatron column- and row-parallel
  products over the tensor axis for heads and mlp, with a vocab-parallel
  embedding and lm_head; a sequence-split residual stream with global RoPE
  positions and ring attention under `sp` (`_Sharded`).
- Under `pp` and `pp_fsdp` (the layer stack split over a `pipeline` axis of
  size P > 1) each rank holds its stage's L/P layers and the layers run as a
  GPipe schedule of microbatches (`_run_layers_pipelined`,
  `parallel/pipeline.py`); under `pp_fsdp` each stage's weights are
  all-gathered once per step. Where the pipeline axis has size 1, or there
  is no mesh, the layers run as they do without it, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.ops.ring_attention import ring_attention, select_kv_heads
from ray_tpu_torch.ops.rotary import apply_rope
from ray_tpu_torch.parallel.collectives import copy_to, gather_from, gather_shards, reduce_from
from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.sharding import (
    Rules,
    local_placements,
    shard_index,
    tree_leaves,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    tie_embeddings: bool = False
    remat: bool = True
    # Remat granularity: None = full per-layer recompute (min memory);
    # "attn" = keep the attention output (the attention forward is not rerun
    # in the backward); "qkv_attn" = also keep post-RoPE q/k/v. A forward
    # without autograd saves nothing either way.
    remat_policy: Optional[str] = None
    attention_impl: Optional[str] = None  # None=auto, see ops.attention
    # Microbatches per pipeline-stage schedule when the rules split the
    # layer stack over a `pipeline` axis of size > 1 (strategy "pp" or
    # "pp_fsdp"); ignored otherwise. None derives the largest divisor of the
    # local batch up to 4 * n_stages (~20% GPipe bubble).
    pp_microbatches: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    # -- presets ---------------------------------------------------------
    @staticmethod
    def tiny(**kw) -> "TransformerConfig":
        """Test-scale model for CPU tests."""
        base = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=torch.float32, remat=False,
        )
        base.update(kw)
        return TransformerConfig(**base)

    @staticmethod
    def llama_1b(**kw) -> "TransformerConfig":
        base = dict(
            vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
            n_kv_heads=16, d_ff=5504, max_seq_len=2048,
        )
        base.update(kw)
        return TransformerConfig(**base)

    @staticmethod
    def llama_7b(**kw) -> "TransformerConfig":
        base = dict(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, d_ff=11008, max_seq_len=4096,
        )
        base.update(kw)
        return TransformerConfig(**base)

    def num_params(self) -> int:
        e = self.vocab_size * self.d_model
        attn = self.d_model * self.head_dim * (2 * self.n_heads + 2 * self.n_kv_heads)
        mlp = 3 * self.d_model * self.d_ff
        norms = 2 * self.d_model
        out = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return e + self.n_layers * (attn + mlp + norms) + self.d_model + out


def _resolve_device(device) -> torch.device:
    """`device`, or the CUDA card when None. The port runs on the card unless
    the caller asks for the CPU: with no card and no device this raises
    instead of quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def param_axes(config: TransformerConfig) -> Dict:
    """Tree of logical-axes tuples, congruent with init_params output."""
    L = ("layers",)
    axes = {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": {
            "attn": {
                "wq": L + ("embed", "heads", "head_dim"),
                "wk": L + ("embed", "kv_heads", "head_dim"),
                "wv": L + ("embed", "kv_heads", "head_dim"),
                "wo": L + ("heads", "head_dim", "embed"),
            },
            "mlp": {
                "w_gate": L + ("embed", "mlp"),
                "w_up": L + ("embed", "mlp"),
                "w_down": L + ("mlp", "embed"),
            },
            "ln1": L + (None,),
            "ln2": L + (None,),
        },
        "final_norm": (None,),
    }
    if not config.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def param_shapes(config: TransformerConfig) -> Dict:
    """Tree of the full parameter shapes, congruent with `param_axes`."""
    c = config
    size = {"layers": c.n_layers, "embed": c.d_model, "heads": c.n_heads,
            "kv_heads": c.n_kv_heads, "head_dim": c.head_dim, "mlp": c.d_ff,
            "vocab": c.vocab_size, None: c.d_model}  # the norms' unnamed dim
    return tree_map(lambda axes: tuple(size[a] for a in axes), param_axes(c))


def init_params(
    config: TransformerConfig,
    generator: torch.Generator,
    *,
    device=None,
) -> Dict:
    """Initialise the parameter tree: the JAX package's tree and scales,
    drawn as plain normal * scale from `generator`, which must live on
    `device` (the card unless device="cpu" is passed). The numbers differ
    from the JAX package's for the same seed; carry weights over with
    `params_from_numpy` where they must agree."""
    c = config
    device = _resolve_device(device)
    pd = c.param_dtype

    def norm_init(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (x * scale).to(pd)

    hd = c.head_dim
    L = c.n_layers
    emb_scale = c.d_model ** -0.5
    proj_scale = c.d_model ** -0.5
    out_scale = (2 * c.n_layers * c.d_model) ** -0.5  # GPT-2-style depth scaling

    params = {
        "embed": {"tokens": norm_init((c.vocab_size, c.d_model), emb_scale)},
        "layers": {
            "attn": {
                "wq": norm_init((L, c.d_model, c.n_heads, hd), proj_scale),
                "wk": norm_init((L, c.d_model, c.n_kv_heads, hd), proj_scale),
                "wv": norm_init((L, c.d_model, c.n_kv_heads, hd), proj_scale),
                "wo": norm_init((L, c.n_heads, hd, c.d_model), out_scale),
            },
            "mlp": {
                "w_gate": norm_init((L, c.d_model, c.d_ff), proj_scale),
                "w_up": norm_init((L, c.d_model, c.d_ff), proj_scale),
                "w_down": norm_init((L, c.d_ff, c.d_model), out_scale),
            },
            "ln1": torch.ones((L, c.d_model), dtype=pd, device=device),
            "ln2": torch.ones((L, c.d_model), dtype=pd, device=device),
        },
        "final_norm": torch.ones((c.d_model,), dtype=pd, device=device),
    }
    if not c.tie_embeddings:
        params["lm_head"] = norm_init((c.d_model, c.vocab_size), emb_scale)
    return params


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


# -- sharding -----------------------------------------------------------------

# Parameter axes a mesh axis may keep split through the forward (tensor
# parallelism): where the rules split a parameter dim and its activation
# (`act_<name>`) over the same mesh axis. Every other split dim is
# all-gathered where it is used (fsdp).
_TENSOR_PARALLEL = ("heads", "kv_heads", "mlp", "vocab")


def _as_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _fitting_axis(axis, sizes, dim: int) -> Optional[str]:
    """Resolve a rules entry to a single mesh axis name that divides dim."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        axis = axis[0] if axis else None
    if axis not in sizes:
        return None
    return axis if dim % sizes[axis] == 0 and sizes[axis] > 1 else None


def _ring_axis(rules: Rules, sizes, seq_len: int) -> Optional[str]:
    """The mesh axis to run ring attention over, or None for local attention.

    Non-None iff the strategy shards act_seq onto a real (>1) mesh axis that
    divides the (global) sequence length — exactly the case where plain
    attention would need the whole sequence."""
    return _fitting_axis(rules.get("act_seq"), sizes, seq_len)


@dataclasses.dataclass(frozen=True)
class _Sharded:
    """What the forward under (rules, mesh) reads, for this rank.

    `gathers` holds per parameter leaf the (dim, process group) of each
    all-gather before its use (fsdp), whose backward sums the ranks'
    gradient contributions: the axis splits the batch, so they differ.
    Dims of the stacked layer leaves are those of one layer's slice. `heads`,
    `mlp` and `vocab` are the tensor-parallel groups of the attention, the
    MLP and the vocabulary (None where the dim is whole on every rank);
    `kv_rank` is (rank, ranks) of the q heads' split where the kv heads are
    not split with them (GQA kv heads that do not divide); `seq` the ring's
    group and `seq_rank` this rank's place in it. `places` is the leaves'
    `local_placements`, which the training step reads too. `pipeline` is
    the mesh axis the layer stack is split over (size > 1), and `pp_fsdp`
    the axis its stages' weights are split over at rest, gathered once per
    step by the schedule (None where there is none)."""

    mesh: Any
    places: Dict
    gathers: Dict
    heads: Optional[Any]
    kv_rank: Optional[Tuple[int, int]]
    mlp: Optional[Any]
    vocab: Optional[Any]
    vocab_rank: int
    seq: Optional[Any]
    seq_rank: int
    pipeline: Optional[str] = None
    pp_fsdp: Optional[str] = None


# The plans built so far, by (config, rules, id(mesh)). A plan holds its
# mesh, so no other mesh can take that id while the entry lives.
_PLANS: Dict[tuple, _Sharded] = {}


def _sharded(config: TransformerConfig, rules: Rules, mesh) -> _Sharded:
    """The plan of the forward under (rules, mesh), built at its first use
    and kept for every later step."""
    key = (config, tuple(sorted((k, _as_axes(v)) for k, v in rules.items())), id(mesh))
    if key not in _PLANS:
        _PLANS[key] = _build_plan(config, rules, mesh)
    return _PLANS[key]


def _pipeline_axes(config: TransformerConfig, rules: Rules,
                   sizes) -> Tuple[Optional[str], Optional[str]]:
    """(the axis the layer stack pipelines over, the fsdp-at-rest axis of
    its stages' weights), both None where the rules' `layers` axis has size
    1 or is absent: the JAX package's checks in `forward`, with its
    errors. Explicit pp intent: misconfigurations are ERRORS, not silent
    fallbacks."""
    ax = rules.get("layers")
    if ax is None:
        return None, None
    ax = ax[0] if isinstance(ax, tuple) else ax
    size = sizes.get(ax, 1)
    if size <= 1:
        return None, None
    if config.n_layers % size != 0:
        raise ValueError(
            f"strategy 'pp': n_layers={config.n_layers} not divisible by "
            f"pipeline axis size {size}"
        )
    sharded_params = [k for k in ("embed", "heads", "kv_heads", "head_dim", "mlp", "vocab",
                                  "expert") if rules.get(k) is not None]
    # fsdp-at-rest composes with pp (strategy "pp_fsdp"); TP-style axes
    # (which also shard activations) do NOT — gathering them would silently
    # undo the tensor split.
    act_axes = set()
    for k, v in rules.items():
        if k.startswith("act_") and k != "act_batch" and v is not None:
            act_axes.update(_as_axes(v))
    pp_fsdp_axes, bad = set(), []
    for k in sharded_params:
        v = rules[k]
        if isinstance(v, tuple) or v == ax or v in act_axes:
            bad.append(k)
        else:
            pp_fsdp_axes.add(v)
    if bad:
        raise ValueError(
            "strategy 'pp' composes with data sharding and ONE "
            "fsdp-at-rest param axis (strategy 'pp_fsdp'); param "
            f"dims {bad} shard over activation/tensor axes the "
            "pipeline schedule cannot gather away"
        )
    if len(pp_fsdp_axes) > 1:
        raise ValueError(
            "strategy 'pp' composes with at most ONE fsdp-at-rest "
            f"param axis, got {sorted(pp_fsdp_axes)} across "
            f"{sharded_params}"
        )
    return ax, (pp_fsdp_axes.pop() if pp_fsdp_axes else None)


def _build_plan(config: TransformerConfig, rules: Rules, mesh) -> _Sharded:
    sizes = mesh_axis_sizes(mesh)
    pp_axis, pp_fsdp = _pipeline_axes(config, rules, sizes)
    seq_axes = [a for a in _as_axes(rules.get("act_seq")) if sizes.get(a, 1) > 1]
    if len(seq_axes) > 1:
        raise NotImplementedError(f"ring attention runs over one mesh axis, got {seq_axes}")
    if pp_axis is not None and seq_axes:
        raise NotImplementedError("the pipeline schedule does not split the sequence")
    # Each rank gets its slice of a sequence split over seq_axes, so the
    # global length is a multiple of their product, and `_ring_axis` answers
    # for any length as it does for that product.
    ring = _ring_axis(rules, sizes, math.prod(sizes[a] for a in seq_axes))
    batch_axes = {a for a in _as_axes(rules.get("act_batch")) + tuple(seq_axes)
                  if sizes.get(a, 1) > 1}
    axes_tree = param_axes(config)
    places = local_placements(param_shapes(config), axes_tree, rules, mesh)
    kept: Dict[str, str] = {}

    def plan(place, logical):
        gathers = []
        for dim, (split, name) in enumerate(zip(place, logical)):
            if name == "layers" and split == (pp_axis,):
                continue  # each rank holds its stage's layers
            act = _as_axes(rules.get(f"act_{name}")) if name else ()
            local = [a for a in split if a in act]
            if local and (name not in _TENSOR_PARALLEL or len(split) > 1):
                raise NotImplementedError(
                    f"the forward keeps only heads, kv_heads, mlp and vocab dims split, each "
                    f"over one mesh axis; got {name!r} over {split}"
                )
            if local:
                kept[name] = local[0]
                continue
            if not set(split) <= batch_axes:
                raise NotImplementedError(
                    f"{name!r} is gathered at its use over {split}, of which only the batch "
                    f"axes {sorted(batch_axes)} can sum the ranks' gradients"
                )
            gathers += [(dim, mesh.get_group(a)) for a in reversed(split)]
        return tuple(gathers)

    gathers = tree_map(plan, places, axes_tree)
    gathers["layers"] = tree_map(lambda g: tuple((d - 1, grp) for d, grp in g),
                                 gathers["layers"])
    heads, kv = kept.get("heads"), kept.get("kv_heads")
    if kv is not None and kv != heads:
        raise NotImplementedError(f"kv heads split over {kv!r} but q heads over {heads!r}")
    group = lambda a: None if a is None else mesh.get_group(a)  # noqa: E731
    return _Sharded(
        mesh=mesh,
        places=places,
        gathers=gathers,
        heads=group(heads),
        kv_rank=shard_index((heads,), mesh) if heads is not None and kv is None else None,
        mlp=group(kept.get("mlp")),
        vocab=group(kept.get("vocab")),
        vocab_rank=mesh.get_local_rank(kept["vocab"]) if "vocab" in kept else 0,
        seq=group(ring),
        seq_rank=mesh.get_local_rank(ring) if ring is not None else 0,
        pipeline=pp_axis,
        pp_fsdp=pp_fsdp,
    )


def _weight(w: torch.Tensor, gathers) -> torch.Tensor:
    """A parameter shard put together for its use: all-gathered over its
    fsdp axes (the minor axis of a dim first), tensor-parallel dims left
    split."""
    for dim, group in gathers:
        w = gather_shards(w, group, dim)
    return w


def _layer_weights(layer_params: Dict, sh: Optional[_Sharded], *names) -> List[torch.Tensor]:
    """The weights `names` ("attn/wq", ...) of one layer, put together for
    their use under `sh`."""
    out = []
    for name in names:
        group, leaf = name.split("/")
        w = layer_params[group][leaf]
        out.append(w if sh is None else _weight(w, sh.gathers["layers"][group][leaf]))
    return out


# -- the decoder ----------------------------------------------------------------


def _qkv(
    x: torch.Tensor,
    layer_params: Dict,
    positions: torch.Tensor,
    config: TransformerConfig,
    sh: Optional[_Sharded] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The segment before attention: rms_norm, q/k/v projections, RoPE."""
    c = config
    dt = c.dtype
    # `.to(dt)` casts each weight at its use, as the JAX package does; it is
    # a no-op for weights a server already holds in the compute dtype (the
    # rounding is the same either way).
    wq, wk, wv = _layer_weights(layer_params, sh, "attn/wq", "attn/wk", "attn/wv")
    h = rms_norm(x, layer_params["ln1"], c.norm_eps)
    if sh is not None:
        h = copy_to(h, sh.heads)  # column-parallel q/k/v over the tensor axis
        if sh.kv_rank is not None:
            # GQA kv heads that do not divide over the tensor axis stay whole
            # on every rank (the JAX package's `_fit_spec` rule); each rank
            # takes those of its own q heads, and the weights' gradients,
            # partial per rank, are summed over the axis.
            wk, wv = (select_kv_heads(copy_to(w, sh.heads), c.n_heads, *sh.kv_rank)
                      for w in (wk, wv))
    q = torch.einsum("bse,ehd->bshd", h, wq.to(dt))
    kk = torch.einsum("bse,ehd->bshd", h, wk.to(dt))
    vv = torch.einsum("bse,ehd->bshd", h, wv.to(dt))
    q = apply_rope(q, positions, theta=c.rope_theta)
    kk = apply_rope(kk, positions, theta=c.rope_theta)
    return q, kk, vv


def _attention(q, kk, vv, config: TransformerConfig, sh: Optional[_Sharded] = None):
    if sh is not None and sh.seq is not None:
        # The sequence is split over the ring's ranks: k/v rotate around it
        # instead of being gathered (ops/ring_attention.py).
        return ring_attention(q, kk, vv, group=sh.seq, causal=True)
    return dot_product_attention(q, kk, vv, causal=True, impl=config.attention_impl)


def _attend(
    x: torch.Tensor,
    layer_params: Dict,
    positions: torch.Tensor,
    config: TransformerConfig,
    sh: Optional[_Sharded] = None,
) -> torch.Tensor:
    q, kk, vv = _qkv(x, layer_params, positions, config, sh)
    return _attention(q, kk, vv, config, sh)


def _out_mlp(
    x: torch.Tensor,
    attn: torch.Tensor,
    layer_params: Dict,
    config: TransformerConfig,
    sh: Optional[_Sharded] = None,
) -> torch.Tensor:
    """The segment after attention: output projection, residual, rms_norm,
    SwiGLU MLP, residual. Under sharding the output projection and w_down
    are row-parallel (their partial sums all-reduced over the tensor axis)
    and w_gate/w_up column-parallel."""
    c = config
    dt = c.dtype
    wo, w_gate, w_up, w_down = _layer_weights(
        layer_params, sh, "attn/wo", "mlp/w_gate", "mlp/w_up", "mlp/w_down")
    out = torch.einsum("bshd,hde->bse", attn, wo.to(dt))
    x = x + (out if sh is None else reduce_from(out, sh.heads))
    h = rms_norm(x, layer_params["ln2"], c.norm_eps)
    if sh is not None:
        h = copy_to(h, sh.mlp)
    gate = torch.einsum("bse,ef->bsf", h, w_gate.to(dt))
    up = torch.einsum("bse,ef->bsf", h, w_up.to(dt))
    ff = torch.nn.functional.silu(gate) * up
    down = torch.einsum("bsf,fe->bse", ff, w_down.to(dt))
    return x + (down if sh is None else reduce_from(down, sh.mlp))


def _layer(
    x: torch.Tensor,
    layer_params: Dict,
    positions: torch.Tensor,
    config: TransformerConfig,
    sh: Optional[_Sharded] = None,
) -> torch.Tensor:
    return _out_mlp(x, _attend(x, layer_params, positions, config, sh), layer_params, config, sh)


def _remat_policy(config: TransformerConfig) -> Optional[str]:
    """Validated remat granularity, as the JAX package's `_remat_policy`
    validates it."""
    if config.remat_policy in (None, "attn", "qkv_attn"):
        return config.remat_policy
    raise ValueError(
        f"unknown remat_policy {config.remat_policy!r}; "
        "expected None, 'attn', or 'qkv_attn'"
    )


def _checkpoint(fn, *args):
    # The layer draws no random numbers, so no RNG state is stashed.
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _remat_layer(
    x: torch.Tensor,
    layer_params: Dict,
    positions: torch.Tensor,
    config: TransformerConfig,
    policy: Optional[str],
    sh: Optional[_Sharded] = None,
) -> torch.Tensor:
    """`_layer` under checkpoints whose boundaries keep what the JAX
    package's policies save (`save_only_these_names`): the layer input
    always; with "attn" also the attention output; with "qkv_attn" also the
    post-RoPE q, k, v (and the flash kernel's lse, which the kernel path
    saves with them, so its forward is not rerun). Everything else is
    recomputed in the backward, fsdp's weight all-gathers included: they
    run inside the segments, so no gathered weight lives from one layer's
    forward to its backward. Selective-checkpoint dispatch modes do not
    see a ctypes kernel as one op, hence the explicit segments."""
    if policy is None:
        return _checkpoint(_layer, x, layer_params, positions, config, sh)
    if policy == "attn":
        attn = _checkpoint(_attend, x, layer_params, positions, config, sh)
    else:
        q, kk, vv = _checkpoint(_qkv, x, layer_params, positions, config, sh)
        attn = _attention(q, kk, vv, config, sh)
    return _checkpoint(_out_mlp, x, attn, layer_params, config, sh)


def _unbind_layers(tree: Dict, n: int) -> List[Dict]:
    """The n layers of a stacked [n, ...] tree, each leaf unbound once along
    its stacked axis: autograd then forms a leaf's gradient in one
    `UnbindBackward0` (a stack of the n slices' gradients) where a per-layer
    `v[i]` makes a zero-filled full-size gradient a layer and adds them."""
    slices = {k: _unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0)
              for k, v in tree.items()}
    return [{k: s[i] for k, s in slices.items()} for i in range(n)]


def _embed(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
           sh: Optional[_Sharded]) -> torch.Tensor:
    """Token embedding; under a vocab-parallel split each rank looks up the
    tokens of its slice of the vocabulary, zero elsewhere, and the rows are
    summed over the tensor axis."""
    w = params["embed"]["tokens"]
    if sh is None:
        return w.to(config.dtype)[tokens]
    w = _weight(w, sh.gathers["embed"]["tokens"]).to(config.dtype)
    if sh.vocab is None:
        return w[tokens]
    rows = w.shape[0]
    local = tokens - sh.vocab_rank * rows
    inside = (local >= 0) & (local < rows)
    x = w[local.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0)
    return reduce_from(x, sh.vocab)


def _logits(params: Dict, x: torch.Tensor, config: TransformerConfig,
            sh: Optional[_Sharded]) -> torch.Tensor:
    """Final norm and lm_head (the transposed embedding when tied): f32
    logits, all-gathered over a vocab-parallel split."""
    c = config
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    head = params["embed"]["tokens"] if c.tie_embeddings else params["lm_head"]
    if sh is not None:
        gathers = sh.gathers["embed"]["tokens"] if c.tie_embeddings else sh.gathers["lm_head"]
        head = _weight(head, gathers)
        x = copy_to(x, sh.vocab)  # column-parallel over the vocabulary
    head = head.T if c.tie_embeddings else head
    logits = torch.einsum("bse,ev->bsv", x, head.to(c.dtype)).to(torch.float32)
    return logits if sh is None else gather_from(logits, sh.vocab, -1)


def forward(
    params: Dict,
    tokens: torch.Tensor,
    config: TransformerConfig,
    *,
    rules: Optional[Rules] = None,
    mesh=None,
) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, vocab] (f32), on the device that
    holds `params` and `tokens`. With `config.remat`, layers run under
    checkpoints when autograd records (see `_remat_layer`).

    Under sharding `rules` and a `mesh` (given together: the port has no
    ambient mesh scope), every rank of the mesh calls this with its shards
    of the parameters (`shard_tree`) and its slice of the batch (batch over
    act_batch's axes, sequence over act_seq's, as
    `LMTrainContext.make_batch` cuts it), and gets the logits of its slice,
    over the whole vocabulary."""
    c = config
    if (rules is None) != (mesh is None):
        raise ValueError("sharding rules and a mesh go together: the port takes its mesh "
                         "explicitly, with no ambient mesh scope")
    sh = None if rules is None else _sharded(c, rules, mesh)
    remat = c.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params)
    )
    x = _embed(params, tokens, c, sh)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if sh is not None and sh.seq is not None:
        positions = positions + sh.seq_rank * tokens.shape[1]  # global positions
    if sh is not None and sh.pipeline is not None:
        x = _run_layers_pipelined(params["layers"], x, positions, c, sh)
    else:
        x = _run_layers(params["layers"], x, positions, c, remat, sh)
    return _logits(params, x, c, sh)


def _run_layers(layer_params: Dict, x: torch.Tensor, positions: torch.Tensor,
                config: TransformerConfig, remat: bool,
                sh: Optional[_Sharded] = None) -> torch.Tensor:
    """The stacked layers [n, ...] of `layer_params`, in order, each under
    the config's remat segments where `remat`."""
    policy = _remat_policy(config) if config.remat else None
    for lp in _unbind_layers(layer_params, tree_leaves(layer_params)[0].shape[0]):
        x = _remat_layer(x, lp, positions, config, policy, sh) if remat else _layer(
            x, lp, positions, config, sh)
    return x


def _run_layers_pipelined(layer_params: Dict, x: torch.Tensor, positions: torch.Tensor,
                          config: TransformerConfig, sh: _Sharded) -> torch.Tensor:
    """This rank's stage of the layer stack as a GPipe pipeline
    (`parallel/pipeline.py`): its L/P layers (the stack split over the
    pipeline axis, stage-major) stacked as the one stage it runs, run on
    each microbatch with the config's remat segments per layer, so the
    attention kernels run once per layer per microbatch in each direction.
    Under pp_fsdp the stage's weights, split over that axis at rest, are
    all-gathered once per step by the schedule."""
    fsdp_dims = None
    if sh.pp_fsdp is not None:
        fsdp_dims = tree_map(
            lambda place: next((d + 1 for d, split in enumerate(place) if sh.pp_fsdp in split),
                               None),
            sh.places["layers"])
    return pipeline_apply(pipeline_stage(config, positions), stack_stages(layer_params, 1), x,
                          sh.mesh, n_microbatches=config.pp_microbatches, axis=sh.pipeline,
                          fsdp_dims=fsdp_dims, fsdp_axis=sh.pp_fsdp or "fsdp")


def stack_stages(layer_params: Dict, n_stages: int) -> Dict:
    """The [L, ...] layer stack as [n_stages, L / n_stages, ...], stage-major:
    the stacked parameters of `pipeline_apply`."""
    return tree_map(lambda a: a.reshape(n_stages, a.shape[0] // n_stages, *a.shape[1:]),
                    layer_params)


def pipeline_stage(config: TransformerConfig, positions: torch.Tensor):
    """One pipeline stage of the decoder, `fn(stage_params, h) -> h` for
    `pipeline_apply` and `pipeline_train_step_1f1b`: the stage's layers
    ([L/P, ...] leaves, unsharded) in order, under the config's remat
    segments where autograd records."""

    def stage(stage_params, h):
        remat = config.remat and torch.is_grad_enabled()
        return _run_layers(stage_params, h, positions, config, remat)

    return stage
