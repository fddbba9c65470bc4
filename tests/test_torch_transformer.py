"""Parity of the port's decoder (`ray_tpu_torch.models`) with the JAX
package's on the CPU, with the same weights carried over by
`params_from_numpy`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jax_tf
from ray_tpu_torch.models import (
    TransformerConfig,
    forward,
    init_params,
    param_axes,
    params_from_numpy,
)
from ray_tpu_torch.models import transformer as tf
from ray_tpu_torch.parallel.sharding import tree_leaves, tree_map

# f32: the frameworks sum the same products in other orders; the largest
# difference seen is ~6e-6 on logits of magnitude ~5.
F32_TOL = 5e-5
# bf16: the frameworks round at other points (XLA fuses elementwise chains in
# f32, PyTorch rounds after each op); 0.15 is ~5 bf16 ulps at |logits| < 8.
BF16_TOL = 0.15


def _jax_params(cfg):
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    return params, jax.tree_util.tree_map(np.asarray, params)


def test_presets_and_num_params_match_jax():
    for name in ("tiny", "llama_1b", "llama_7b"):
        ours, theirs = getattr(TransformerConfig, name)(), getattr(jax_tf.TransformerConfig, name)()
        for f in dataclasses.fields(theirs):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(ours, f.name) == getattr(theirs, f.name), (name, f.name)
        assert ours.dtype == getattr(torch, jnp.dtype(theirs.dtype).name)
        assert ours.num_params() == theirs.num_params()
        assert ours.head_dim == theirs.head_dim
    assert param_axes(TransformerConfig.tiny()) == jax_tf.param_axes(jax_tf.TransformerConfig.tiny())


def test_init_params_tree_matches_jax():
    cfg = TransformerConfig.tiny()
    ours = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, theirs = _jax_params(jax_tf.TransformerConfig.tiny())

    def walk(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                assert tuple(a[k].shape) == b[k].shape and a[k].dtype == torch.float32
                # Same scale: sample std within 20% of the JAX draw's.
                if a[k].numel() > 1000:
                    assert abs(a[k].std().item() / b[k].std() - 1) < 0.2

    walk(ours, theirs)


@pytest.mark.parametrize(
    "dtype,seq,tol",
    [("float32", 16, F32_TOL), ("bfloat16", 16, BF16_TOL), ("float32", 640, F32_TOL)],
    ids=["f32", "bf16", "f32_blockwise"],
)
def test_forward_logits_match_jax(dtype, seq, tol):
    """tiny (GQA 4/2). seq=640 > 512 takes the blockwise branch in both."""
    cfg_j = jax_tf.TransformerConfig.tiny(dtype=getattr(jnp, dtype))
    cfg_t = TransformerConfig.tiny(dtype=getattr(torch, dtype))
    params_j, params_np = _jax_params(cfg_j)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, seq))
    theirs = np.asarray(jax.jit(lambda p, t: jax_tf.forward(p, t, cfg_j))(params_j, tokens))
    ours = forward(params_from_numpy(params_np, device="cpu"), torch.from_numpy(tokens), cfg_t)
    assert ours.dtype == torch.float32 and ours.shape == (2, seq, cfg_t.vocab_size)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=tol, rtol=0)


def test_forward_tied_embeddings_match_jax():
    cfg_j = jax_tf.TransformerConfig.tiny(tie_embeddings=True)
    cfg_t = TransformerConfig.tiny(tie_embeddings=True)
    params_j, params_np = _jax_params(cfg_j)
    assert "lm_head" not in params_np
    tokens = np.random.default_rng(1).integers(0, 256, (1, 12))
    theirs = np.asarray(jax_tf.forward(params_j, tokens, cfg_j))
    ours = forward(params_from_numpy(params_np, device="cpu"), torch.from_numpy(tokens), cfg_t)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=F32_TOL, rtol=0)


def test_params_from_numpy_casts_when_asked():
    _, params_np = _jax_params(jax_tf.TransformerConfig.tiny())
    params = params_from_numpy(params_np, device="cpu", dtype=torch.bfloat16)
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tuple(params["layers"]["attn"]["wq"].shape) == params_np["layers"]["attn"]["wq"].shape


def test_forward_rejects_multi_device_requests():
    """Rules need an explicit mesh (the port has no ambient mesh scope).
    pp_microbatches without a pipeline axis is ignored, as the JAX forward
    ignores it."""
    cfg = TransformerConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="mesh"):
        forward(params, tokens, cfg, rules={"act_batch": "data"})
    assert torch.equal(forward(params, tokens, TransformerConfig.tiny(pp_microbatches=2)),
                       forward(params, tokens, cfg))


# Pipelined rules the JAX forward refuses on a mesh with a pipeline axis of
# size 2: (rules overrides, config overrides).
PP_MISCONFIGURED = [
    ({}, {"n_layers": 3}),  # the stack does not split into 2 stages
    ({"heads": "tensor", "act_heads": "tensor"}, {}),  # a tensor-parallel dim
    ({"embed": "fsdp", "mlp": "data"}, {}),  # two fsdp-at-rest axes
    ({"embed": "pipeline"}, {}),  # a parameter dim over the pipeline axis
]


@pytest.mark.parametrize("rules_kw,cfg_kw", PP_MISCONFIGURED,
                         ids=["layers", "tensor", "two_fsdp", "over_pipeline"])
def test_pipelined_misconfigurations_raise_the_jax_errors(rules_kw, cfg_kw):
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    from ray_tpu.parallel import resolve_rules as jax_resolve_rules
    from ray_tpu_torch.models.transformer import _pipeline_axes

    spec = dict(data=1, pipeline=2, tensor=2, fsdp=2)
    jcfg = jax_tf.TransformerConfig.tiny(**cfg_kw)
    rules = dict(jax_resolve_rules("pp"), **rules_kw)
    mesh = jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:8])
    with pytest.raises(ValueError) as theirs:
        jax_tf.forward(jax_tf.init_params(jcfg, jax.random.PRNGKey(0)),
                       jnp.zeros((2, 8), jnp.int32), jcfg, rules=rules, mesh=mesh)
    sizes = {"data": 1, "fsdp": 2, "expert": 1, "pipeline": 2, "seq": 1, "tensor": 2}
    with pytest.raises(ValueError) as ours:
        _pipeline_axes(TransformerConfig.tiny(**cfg_kw), rules, sizes)
    assert str(ours.value) == str(theirs.value)


# The stacked [L, ...] layer leaves are unbound once a forward
# (`_unbind_layers`); the reference below slices them per layer with `v[i]`,
# as the port did before. The two give the same maths and the same rounding,
# so gradients and logits are held to each other bitwise.
REMAT_CASES = [(False, None), (True, None), (True, "attn"), (True, "qkv_attn")]
REMAT_IDS = ["remat_off", "remat_none", "remat_attn", "remat_qkv_attn"]


def _indexed_run_layers(layer_params, x, positions, config, remat, sh=None):
    policy = tf._remat_policy(config) if config.remat else None
    for i in range(tree_leaves(layer_params)[0].shape[0]):
        lp = tree_map(lambda v: v[i], layer_params)
        x = tf._remat_layer(x, lp, positions, config, policy, sh) if remat else tf._layer(
            x, lp, positions, config, sh)
    return x


def _unbind_case(remat, policy):
    """A 4-layer tiny decoder computing in bf16 over f32 master leaves that
    require grad, and a batch of its tokens."""
    cfg = TransformerConfig.tiny(n_layers=4, dtype=torch.bfloat16, remat=remat,
                                 remat_policy=policy)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for leaf in tree_leaves(params):
        assert leaf.dtype == torch.float32
        leaf.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)))
    return cfg, params, tokens


def _loss(logits, tokens):
    return torch.nn.functional.cross_entropy(logits.flatten(0, 1), tokens.flatten())


def _node_counts(root, names):
    counts, seen, todo = dict.fromkeys(names, 0), set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if node.name() in counts:
            counts[node.name()] += 1
        todo.extend(n for n, _ in node.next_functions)
    return counts


@pytest.mark.parametrize("remat,policy", REMAT_CASES, ids=REMAT_IDS)
def test_unbound_layers_grads_equal_per_layer_indexing(remat, policy, monkeypatch):
    cfg, params, tokens = _unbind_case(remat, policy)
    ours = torch.autograd.grad(_loss(forward(params, tokens, cfg), tokens), tree_leaves(params))
    monkeypatch.setattr(tf, "_run_layers", _indexed_run_layers)
    theirs = torch.autograd.grad(_loss(forward(params, tokens, cfg), tokens), tree_leaves(params))
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("remat,policy", REMAT_CASES, ids=REMAT_IDS)
def test_backward_graph_has_one_unbind_per_stacked_leaf(remat, policy):
    cfg, params, tokens = _unbind_case(remat, policy)
    loss = _loss(forward(params, tokens, cfg), tokens)
    counts = _node_counts(loss.grad_fn, ("UnbindBackward0", "SelectBackward0"))
    assert counts == {"UnbindBackward0": len(tree_leaves(params["layers"])), "SelectBackward0": 0}


def test_pipeline_stage_grads_equal_per_layer_indexing(monkeypatch):
    """One stage of two over the 4-layer stack ([L/P, ...] = [2, ...] leaves),
    as `pipeline_apply` and the 1F1B schedule call it, in one process."""
    cfg, params, tokens = _unbind_case(True, "qkv_attn")
    stage_params = tree_map(lambda v: v[1].detach().requires_grad_(True),
                            tf.stack_stages(params["layers"], 2))
    stage_leaves = tree_leaves(stage_params)
    h = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(3)).to(
        cfg.dtype).requires_grad_(True)
    stage = tf.pipeline_stage(cfg, torch.arange(16))

    def grads():
        out = stage(stage_params, h)
        return torch.autograd.grad(out.float().square().mean(), [h, *stage_leaves]), out

    ours, out = grads()
    counts = _node_counts(out.grad_fn, ("UnbindBackward0", "SelectBackward0"))
    assert counts == {"UnbindBackward0": len(stage_leaves), "SelectBackward0": 0}
    monkeypatch.setattr(tf, "_run_layers", _indexed_run_layers)
    theirs, _ = grads()
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


def test_forward_without_grad_equals_per_layer_indexing(monkeypatch):
    cfg, params, tokens = _unbind_case(True, "qkv_attn")
    with torch.no_grad():
        ours = forward(params, tokens, cfg)
        monkeypatch.setattr(tf, "_run_layers", _indexed_run_layers)
        theirs = forward(params, tokens, cfg)
    assert ours.grad_fn is None and torch.equal(ours, theirs)
