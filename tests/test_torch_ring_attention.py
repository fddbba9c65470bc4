"""The port's ring attention (`ray_tpu_torch.ops.ring_attention`) on 4 CPU
processes joined in a gloo group (a ring of 4 over the `seq` axis), against
the JAX package: its `ring_attention_sharded` on the 8-device virtual CPU
mesh (data=2, seq=4), `reference_attention`, `jax.grad` of it, and the
unsharded forward of the tiny model for the port's `sp` strategy.

One run of the 4 ranks computes every case (module fixture); the tests
read its results. Inputs and weights come from numpy seeds and the JAX
tree; the JAX side runs in this process, and the ranks import no jax (this
module imports it only inside functions).
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import LMTrainContext, TransformerConfig, state_from_numpy
from ray_tpu_torch.models import transformer
from ray_tpu_torch.ops.cuda import flash_attention as flash
from ray_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded, ring_schedule
from ray_tpu_torch.parallel import MeshSpec, build_mesh
from ray_tpu_torch.parallel.sharding import all_gather_dim
from torch_ranks import run_local_ranks

WORLD = 4
B, S, H, D = 2, 64, 4, 16
# Forward against the JAX ring and the reference: the tolerance of
# tests/test_ops_attention.py::test_ring_attention_matches_reference.
FWD_TOL = 2e-5
# Gradients against jax.grad of the reference attention: f32 partials of
# 4 chunk pairs summed in another order than one softmax over the row.
GRAD_TOL = 2e-5
# The sp forward of the tiny model against the unsharded one, as
# tests/test_models.py::test_sequence_parallel_forward holds it.
MODEL_TOL = 1e-4
CASES = [(causal, kv) for causal in (True, False) for kv in (4, 2)]
IDS = [f"{'causal' if c else 'full'}_{H}_{kv}" for c, kv in CASES]


def _inputs(kv: int):
    rng = np.random.default_rng(5 + kv)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, kv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, kv, D), dtype=np.float32)
    do = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, do


def _model_inputs():
    import jax

    from ray_tpu.models import transformer as jax_tf

    cfg = jax_tf.TransformerConfig.tiny(attention_impl="reference")
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    ref = np.asarray(jax_tf.forward(params, tokens, cfg))
    return jax.tree_util.tree_map(np.asarray, params), tokens, ref


def _ranks(rank, cases, params0, tokens, out_dir):
    mesh = build_mesh(MeshSpec(data=1, seq=WORLD), device_type="cpu")
    group, my = mesh.get_group("seq"), mesh.get_local_rank("seq")
    chunk = S // WORLD
    out = {}
    for causal, kv in cases:
        q, k, v, do = (torch.from_numpy(x) for x in _inputs(kv))
        out[f"fwd_{causal}_{kv}"] = ring_attention_sharded(q, k, v, mesh, causal=causal,
                                                           head_axis=None)
        local = [x[:, my * chunk:(my + 1) * chunk].clone().requires_grad_(True)
                 for x in (q, k, v)]
        ring_attention(*local, group=group, causal=causal).backward(
            do[:, my * chunk:(my + 1) * chunk])
        for name, x in zip(("dq", "dk", "dv"), local):
            out[f"{name}_{causal}_{kv}"] = all_gather_dim(x.grad, group, 1)
    # The tiny model under sp: a seq-split residual stream, ring attention.
    calls = []
    counted = lambda *a, **kw: calls.append(1) or ring(*a, **kw)  # noqa: E731
    ring, transformer.ring_attention = transformer.ring_attention, counted
    ctx = LMTrainContext(TransformerConfig.tiny(), mesh, "sp")
    params = state_from_numpy(params0, ctx.config, device="cpu", mesh=mesh,
                              strategy="sp")["params"]
    out["sp_logits"] = ctx.apply(params, tokens)
    out["sp_ring_calls"] = len(calls)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    params0, tokens, _ = _model_inputs()
    run_local_ranks(_ranks, WORLD, (CASES, params0, tokens, str(tmp)),
                    init_file=str(tmp / "rdzv"))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]


@functools.lru_cache(maxsize=None)
def _jax_side(causal: bool, kv: int):
    """The JAX ring on the (data=2, seq=4) virtual mesh, the reference, and
    jax.grad of the reference against dO."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import reference_attention
    from ray_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh

    q, k, v, do = (jnp.asarray(x) for x in _inputs(kv))
    mesh = jax_build_mesh(JaxMeshSpec(data=2, seq=4, tensor=1))
    ring = jax_ring(q, k, v, mesh, causal=causal, head_axis=None)
    ref = reference_attention(q, k, v, causal=causal)
    grads = jax.grad(lambda *a: jnp.sum(reference_attention(*a, causal=causal) * do),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(ring), np.asarray(ref), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal,kv", CASES, ids=IDS)
def test_ring_forward_matches_jax_ring_and_reference(results, causal, kv):
    jax_ring, ref, _ = _jax_side(causal, kv)
    for out in results:
        ours = out[f"fwd_{causal}_{kv}"].numpy()
        np.testing.assert_allclose(ours, jax_ring, atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(ours, ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal,kv", CASES, ids=IDS)
def test_ring_grads_match_jax_grad_of_reference(results, causal, kv):
    _, _, grads = _jax_side(causal, kv)
    for out in results:
        for name, theirs in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(out[f"{name}_{causal}_{kv}"].numpy(), theirs,
                                       atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_sp_forward_matches_unsharded_forward(results):
    _, _, ref = _model_inputs()
    for out in results:
        np.testing.assert_allclose(out["sp_logits"].numpy(), ref, atol=MODEL_TOL, rtol=MODEL_TOL)


def test_sp_runs_ring_attention_in_every_layer(results):
    """The sp strategy rotates k/v around the ring in every layer instead of
    gathering the sequence (the port's test_sp_actually_runs_ring_attention)."""
    n_layers = TransformerConfig.tiny().n_layers
    assert [out["sp_ring_calls"] for out in results] == [n_layers] * WORLD


def test_ring_attention_sharded_names_the_seq_axis_that_does_not_divide():
    mesh_sizes = {"data": 1, "fsdp": 1, "expert": 1, "pipeline": 1, "seq": 3, "tensor": 1}

    class _Mesh:  # the sizes are all the check reads
        mesh_dim_names = tuple(mesh_sizes)
        shape = tuple(mesh_sizes.values())

    q = torch.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError, match="not divisible by mesh axis 'seq'"):
        ring_attention_sharded(q, q, q, _Mesh())


@pytest.mark.parametrize("causal", [True, False])
def test_ring_schedule_matches_whole_sequence_plain(causal):
    """The ring's chunk schedule run in one process (as chip_smoke.py runs
    it on the card) against the plain whole-sequence forward and backward,
    f32 on the CPU."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2))
    o, lse, *grads = ring_schedule(q, k, v, do, n=WORLD, causal=causal)
    o_p, lse_p = flash.flash_attention_fwd_plain(q, k, v, causal=causal)
    plain = flash.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=causal)
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), atol=FWD_TOL, rtol=FWD_TOL)
    for ours, theirs in zip(grads, plain):
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_plain_bwd_with_supplied_delta_is_the_same():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2))
    o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    own = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    given = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                      delta=flash._delta(do, o))
    for a, b in zip(own, given):
        assert torch.equal(a, b)
