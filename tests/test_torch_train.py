"""Parity of the port's training slice (`ray_tpu_torch.models.lm`, remat in
`ray_tpu_torch.models.transformer`) with the JAX package's on the CPU.

Weights come from the JAX `init_params` tree, carried over by
`params_from_numpy` / `state_from_numpy`; batches and the optimizer test's
gradients come from seeded numpy generators. Everything runs in f32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import lm as jax_lm
from ray_tpu.models import transformer as jax_tf
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu_torch.models import (
    LMTrainContext,
    TransformerConfig,
    cross_entropy_loss,
    default_optimizer,
    forward,
    params_from_numpy,
    state_from_numpy,
)
from ray_tpu_torch.models import transformer
from ray_tpu_torch.parallel import resolve_rules

# Parameter gradients of the loss at f32: the two frameworks sum the same
# products in other orders through two layers and the loss; the largest
# difference seen is 3e-7 on gradients up to 0.37.
GRAD_TOL = 1e-5
# Loss and gradient norm of a training step: one scalar each, summed over the
# batch and the parameters in another order.
STEP_RTOL = 1e-5
# Parameters after 3 AdamW steps; the largest difference seen is 7e-7.
# Adam divides each moment by the root of its square, so a gradient entry
# whose sign lies within its rounding difference of zero would move its
# parameter by up to the learning rate (3e-4) a step. The smallest nonzero
# |gradient| of this batch is 3e-7, far above the frameworks' difference on
# it, so no update flips and 1e-5 holds the rest to f32 rounding.
PARAM_ATOL = 1e-5
# One optimizer update from the same tree: the same formulas at f32, a few
# ulps apart in where they round (the moments' bias correction, the clip).
OPT_TOL = 1e-6


def _batch(seed, b=2, s=16, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_params():
    params = jax_tf.init_params(jax_tf.TransformerConfig.tiny(), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_grads(seq, impl):
    """jax.grad of the JAX loss on tiny at f32 (remat off: the gradients do
    not depend on the policy)."""
    cfg = jax_tf.TransformerConfig.tiny(attention_impl=impl)
    batch = _batch(1, s=seq)

    def loss_fn(params):
        logits = jax_tf.forward(params, batch["tokens"], cfg)
        return jax_lm.cross_entropy_loss(logits, batch["targets"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(_jax_params())
    return float(loss), jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, grads))


def _port_grads(cfg, seq):
    params = params_from_numpy(_jax_params(), device="cpu")
    leaves = jax.tree_util.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = _batch(1, s=seq)
    logits = forward(params, torch.from_numpy(batch["tokens"]).long(), cfg)
    loss = cross_entropy_loss(logits, torch.from_numpy(batch["targets"]).long())
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize(
    "remat,policy,impl,seq",
    [(False, None, None, 16), (True, None, None, 16), (True, "attn", None, 16),
     (True, "qkv_attn", None, 16), (True, "qkv_attn", "pallas", 128)],
    ids=["no_remat", "remat_full", "remat_attn", "remat_qkv_attn", "pallas_qkv_attn"],
)
def test_model_grads_match_jax(remat, policy, impl, seq):
    """Gradients of the loss on tiny, for every remat policy: the policy
    changes what is recomputed, never the gradients. With "pallas" the
    port's `_FlashAttention` runs inside the model (its plain versions on
    the CPU) against the JAX Pallas kernels in interpret mode."""
    cfg = TransformerConfig.tiny(remat=remat, remat_policy=policy, attention_impl=impl)
    loss_j, grads_j = _jax_grads(seq, impl)
    loss_t, grads_t = _port_grads(cfg, seq)
    np.testing.assert_allclose(loss_t, loss_j, rtol=STEP_RTOL)
    assert len(grads_t) == len(grads_j)
    for ours, theirs in zip(grads_t, grads_j):
        np.testing.assert_allclose(ours, theirs, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize(
    "remat,policy,attn,qkv,out",
    [(False, None, 1, 1, 1), (True, "qkv_attn", 1, 2, 2), (True, "attn", 2, 2, 2),
     (True, None, 2, 2, 2)],
    ids=["no_remat", "qkv_attn", "attn", "full"],
)
def test_remat_reruns_what_jax_reruns(monkeypatch, remat, policy, attn, qkv, out):
    """Calls per layer over one forward and loss.backward(): the attention
    forward runs once with no remat and with qkv_attn (q, k, v and the
    attention output are kept), twice with attn and None (recomputed); the
    q/k/v projections and the segment after attention run twice under every
    policy and once without remat."""
    calls = {"attn": 0, "qkv": 0, "out": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(transformer, "dot_product_attention",
                        counted("attn", transformer.dot_product_attention))
    monkeypatch.setattr(transformer, "_qkv", counted("qkv", transformer._qkv))
    monkeypatch.setattr(transformer, "_out_mlp", counted("out", transformer._out_mlp))
    cfg = TransformerConfig.tiny(remat=remat, remat_policy=policy)
    params = params_from_numpy(_jax_params(), device="cpu")
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    batch = _batch(2)
    logits = forward(params, torch.from_numpy(batch["tokens"]).long(), cfg)
    cross_entropy_loss(logits, torch.from_numpy(batch["targets"]).long()).backward()
    n = cfg.n_layers
    assert calls == {"attn": attn * n, "qkv": qkv * n, "out": out * n}


def test_remat_is_off_without_autograd(monkeypatch):
    """A forward that records no gradient runs the layers as they are."""
    monkeypatch.setattr(transformer, "checkpoint", None)  # would raise if called
    cfg = TransformerConfig.tiny(remat=True, remat_policy="qkv_attn")
    params = params_from_numpy(_jax_params(), device="cpu")
    forward(params, torch.zeros((1, 8), dtype=torch.long), cfg)


def test_training_matches_jax_train_context():
    """Three steps of the port's LMTrainContext on tiny against the JAX
    LMTrainContext (strategy dp on a one-device mesh) from the same initial
    state, on one batch: loss and grad norm each step, params after."""
    jax_ctx = jax_lm.LMTrainContext(
        jax_tf.TransformerConfig.tiny(), build_mesh(MeshSpec(data=1), devices=jax.devices()[:1]),
        "dp",
    )
    jax_state = jax_ctx.init_state(0)
    ctx = LMTrainContext(TransformerConfig.tiny(), device="cpu")
    state = state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_state["params"]), ctx.config, device="cpu"
    )
    batch = _batch(3, b=4, s=32)
    for step in range(3):
        jax_state, jm = jax_ctx.train_step(jax_state, batch)
        state, m = ctx.train_step(state, batch)
        assert m["step"] == int(jm["step"]) == step + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_RTOL)
    theirs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jax_state["params"]))
    ours = jax.tree_util.tree_leaves(state["params"])
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["under_clip", "clipped"])
def test_default_optimizer_matches_optax(scale):
    """Two updates of the port's clip + AdamW against optax's chain on one
    tree, with a gradient norm under and over the clip's 1.0."""
    rng = np.random.default_rng(4)
    shapes = [(8, 4), (4,), (3, 5, 2)]
    params = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    grads = [[scale * rng.standard_normal(s, dtype=np.float32) for s in shapes]
             for _ in range(2)]
    tx = jax_lm.default_optimizer()
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    opt = default_optimizer()
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for g in grads:
        updates, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        ts = opt.update([torch.from_numpy(x.copy()) for x in g], ts, tp)
    assert ts["count"] == 2 and ts["mu"][0].dtype == torch.float32
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OPT_TOL, rtol=OPT_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 11), dtype=np.float32)
    targets = rng.integers(0, 11, (2, 6))
    mask = (rng.random((2, 6)) > 0.5).astype(np.float32) if masked else None
    ours = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                              None if mask is None else torch.from_numpy(mask))
    theirs = jax_lm.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                       None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=STEP_RTOL)


def test_masked_loss_with_nothing_unmasked_is_zero():
    """sum(ll * mask) / max(sum(mask), 1): an all-zero mask gives 0, not NaN."""
    loss = cross_entropy_loss(torch.randn(1, 3, 5), torch.zeros((1, 3), dtype=torch.long),
                              torch.zeros((1, 3)))
    assert float(loss) == 0.0


def test_masked_batch_trains():
    ctx = LMTrainContext(TransformerConfig.tiny(), device="cpu")
    state = state_from_numpy(_jax_params(), ctx.config, device="cpu")
    batch = dict(_batch(6), mask=np.ones((2, 16), dtype=np.float32))
    _, m = ctx.train_step(state, batch)
    assert np.isfinite(float(m["loss"])) and m["step"] == 1


@pytest.mark.parametrize("strategy", ["fsdp", "tp", "pp"])
def test_other_strategies_and_meshes_are_not_ported_yet(strategy):
    """Every strategy is ported now, pipelined ones included: without a mesh
    a strategy that puts the layer stack on the pipeline axis is the plain
    step, as in the JAX package, which pipelines only over an axis of size
    > 1. What stays refused is a mesh that is not a torch DeviceMesh."""
    rules = dict(resolve_rules(strategy), layers="pipeline")
    metrics = []
    for s in (rules, "dp"):
        ctx = LMTrainContext(TransformerConfig.tiny(), strategy=s, device="cpu")
        _, m = ctx.train_step(state_from_numpy(_jax_params(), ctx.config, device="cpu"), _batch(7))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert metrics[0] == metrics[1]
    with pytest.raises(TypeError, match="DeviceMesh"):
        LMTrainContext(TransformerConfig.tiny(), object(), device="cpu")


def test_unknown_remat_policy_raises():
    cfg = TransformerConfig.tiny(remat=True, remat_policy="everything")
    ctx = LMTrainContext(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ctx.train_step(state_from_numpy(_jax_params(), cfg, device="cpu"), _batch(7))


def test_state_from_numpy_starts_at_step_zero():
    cfg = dataclasses.replace(TransformerConfig.tiny(), param_dtype=torch.bfloat16)
    state = state_from_numpy(_jax_params(), cfg, device="cpu")
    wq = state["params"]["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.requires_grad
    assert state["step"] == 0 and state["opt_state"]["count"] == 0
    assert all(float(m.abs().sum()) == 0.0 for m in state["opt_state"]["mu"])
    assert state["opt_state"]["nu"][0].dtype == torch.bfloat16  # the params' dtype


# The step at bf16 parameters (f32 compute) against the JAX step. The loss of
# step 1 agrees to f32 rounding; steps 2 and 3 start from parameters that
# differ where the two frameworks round a bf16 moment or update differently
# (measured 8e-6 relative by step 3). The JAX gradient norm is summed in bf16
# (optax.global_norm in the gradients' type), the port's in f32: within one
# bf16 ulp of the norm, 2^-7 relative (measured 2.6e-3). Parameters: where an
# update rounds to the other neighbour, a bf16 parameter moves by one ulp of
# itself; measured at most 2e-3 of each leaf's largest |value| and 2.6% of the
# elements, so each leaf is held to 1e-2 of its largest |value| and 5% of its
# elements differing at all.
BF16_LOSS_RTOL = 1e-4
BF16_GRAD_NORM_RTOL = 2.0 ** -7
BF16_PARAM_REL = 1e-2
BF16_PARAM_SHARE = 0.05


def test_bf16_tree_carries_over_bit_exactly():
    """The numpy leaves of a bf16 JAX tree (ml_dtypes.bfloat16) come over
    as torch.bfloat16 with the same bits."""
    cfg = jax_tf.TransformerConfig.tiny(param_dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jax_tf.init_params(cfg, jax.random.PRNGKey(0)))
    ours = jax.tree_util.tree_leaves(params_from_numpy(tree, device="cpu"))
    theirs = jax.tree_util.tree_leaves(tree)
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.view(torch.int16).numpy().view(np.uint16),
                                      b.view(np.uint16))
    state = state_from_numpy(tree, TransformerConfig.tiny(param_dtype=torch.bfloat16),
                             device="cpu")
    np.testing.assert_array_equal(
        state["params"]["lm_head"].detach().view(torch.int16).numpy().view(np.uint16),
        tree["lm_head"].view(np.uint16))


def test_bf16_param_training_matches_jax_train_context():
    """Three steps at param_dtype bf16 (moments in bf16 too, as optax keeps
    them in the params' type) against the JAX LMTrainContext (dp, one
    device), from the same bf16 tree, on one batch."""
    jax_ctx = jax_lm.LMTrainContext(
        jax_tf.TransformerConfig.tiny(param_dtype=jnp.bfloat16),
        build_mesh(MeshSpec(data=1), devices=jax.devices()[:1]), "dp",
    )
    jax_state = jax_ctx.init_state(0)
    ctx = LMTrainContext(TransformerConfig.tiny(param_dtype=torch.bfloat16), device="cpu")
    state = state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_state["params"]), ctx.config, device="cpu"
    )
    assert state["opt_state"]["mu"][0].dtype == torch.bfloat16
    batch = _batch(3, b=4, s=32)
    for _ in range(3):
        jax_state, jm = jax_ctx.train_step(jax_state, batch)
        state, m = ctx.train_step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=BF16_GRAD_NORM_RTOL)
    theirs = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax_state["params"]))
    ours = jax.tree_util.tree_leaves(state["params"])
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.bfloat16
        a = a.detach().float().numpy()
        assert np.abs(a - b).max() <= BF16_PARAM_REL * np.abs(b).max()
        assert (a != b).mean() <= BF16_PARAM_SHARE
