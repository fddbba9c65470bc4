"""Flagship model: Llama-family decoder-only transformer, port of
`ray_tpu/models/transformer.py` (single-device path).

- Parameters are a plain dict tree with the JAX package's names, shapes and
  layouts (no transposes): `wq` is [L, E, H, Dh], `wo` [L, H, Dh, E], the
  layers stacked on a leading [L] axis. `forward` loops over that axis where
  the JAX package runs `lax.scan`.
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

Sharding rules, ring attention and pipelining belong to the multi-device
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.ops.rotary import apply_rope


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
    # Microbatches per pipeline-stage schedule; pipelining belongs to the
    # multi-device slice, so forward() rejects a config that sets it.
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


def _qkv(
    x: torch.Tensor,
    layer_params: Dict,
    positions: torch.Tensor,
    config: TransformerConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The segment before attention: rms_norm, q/k/v projections, RoPE."""
    c = config
    dt = c.dtype
    # `.to(dt)` casts each weight at its use, as the JAX package does; it is
    # a no-op for weights a server already holds in the compute dtype (the
    # rounding is the same either way).
    attn_p = layer_params["attn"]
    h = rms_norm(x, layer_params["ln1"], c.norm_eps)
    q = torch.einsum("bse,ehd->bshd", h, attn_p["wq"].to(dt))
    kk = torch.einsum("bse,ehd->bshd", h, attn_p["wk"].to(dt))
    vv = torch.einsum("bse,ehd->bshd", h, attn_p["wv"].to(dt))
    q = apply_rope(q, positions, theta=c.rope_theta)
    kk = apply_rope(kk, positions, theta=c.rope_theta)
    return q, kk, vv


def _attend(
    x: torch.Tensor,
    layer_params: Dict,
    positions: torch.Tensor,
    config: TransformerConfig,
) -> torch.Tensor:
    q, kk, vv = _qkv(x, layer_params, positions, config)
    return dot_product_attention(q, kk, vv, causal=True, impl=config.attention_impl)


def _out_mlp(
    x: torch.Tensor,
    attn: torch.Tensor,
    layer_params: Dict,
    config: TransformerConfig,
) -> torch.Tensor:
    """The segment after attention: output projection, residual, rms_norm,
    SwiGLU MLP, residual."""
    c = config
    dt = c.dtype
    x = x + torch.einsum("bshd,hde->bse", attn, layer_params["attn"]["wo"].to(dt))
    mlp_p = layer_params["mlp"]
    h = rms_norm(x, layer_params["ln2"], c.norm_eps)
    gate = torch.einsum("bse,ef->bsf", h, mlp_p["w_gate"].to(dt))
    up = torch.einsum("bse,ef->bsf", h, mlp_p["w_up"].to(dt))
    ff = torch.nn.functional.silu(gate) * up
    return x + torch.einsum("bsf,fe->bse", ff, mlp_p["w_down"].to(dt))


def _layer(
    x: torch.Tensor,
    layer_params: Dict,
    positions: torch.Tensor,
    config: TransformerConfig,
) -> torch.Tensor:
    return _out_mlp(x, _attend(x, layer_params, positions, config), layer_params, config)


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
) -> torch.Tensor:
    """`_layer` under checkpoints whose boundaries keep what the JAX
    package's policies save (`save_only_these_names`): the layer input
    always; with "attn" also the attention output; with "qkv_attn" also the
    post-RoPE q, k, v (and the flash kernel's lse, which the kernel path
    saves with them, so its forward is not rerun). Everything else is
    recomputed in the backward. Selective-checkpoint dispatch modes do not
    see a ctypes kernel as one op, hence the explicit segments."""
    if policy is None:
        return _checkpoint(_layer, x, layer_params, positions, config)
    if policy == "attn":
        attn = _checkpoint(_attend, x, layer_params, positions, config)
    else:
        q, kk, vv = _checkpoint(_qkv, x, layer_params, positions, config)
        attn = dot_product_attention(q, kk, vv, causal=True, impl=config.attention_impl)
    return _checkpoint(_out_mlp, x, attn, layer_params, config)


def _leaves(tree: Dict) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _index_layer(tree: Dict, i: int) -> Dict:
    return {
        k: _index_layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()
    }


def forward(
    params: Dict,
    tokens: torch.Tensor,
    config: TransformerConfig,
    *,
    rules: Optional[Dict] = None,
    mesh=None,
) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, vocab] (f32), on the device that
    holds `params` and `tokens`. With `config.remat`, layers run under
    checkpoints when autograd records (see `_remat_layer`)."""
    if rules is not None or mesh is not None:
        raise NotImplementedError(
            "sharding rules and meshes come with the multi-device slice of the port"
        )
    if config.pp_microbatches is not None:
        raise NotImplementedError("pipelining comes with the multi-device slice of the port")
    c = config
    policy = _remat_policy(c) if c.remat else None
    remat = c.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(params)
    )
    x = params["embed"]["tokens"].to(c.dtype)[tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(c.n_layers):
        layer_params = _index_layer(params["layers"], i)
        if remat:
            x = _remat_layer(x, layer_params, positions, c, policy)
        else:
            x = _layer(x, layer_params, positions, c)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    head = params["embed"]["tokens"].T if c.tie_embeddings else params["lm_head"]
    return torch.einsum("bse,ev->bsv", x, head.to(c.dtype)).to(torch.float32)
