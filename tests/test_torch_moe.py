"""The port's MoE block (`ray_tpu_torch.models.moe`) against the JAX
package's (`ray_tpu.models.moe`): the plain call's output, aux loss and
gradients, the capacity drop, and the expert-parallel call on 4 CPU
processes joined in a gloo group against the unsharded JAX call, with
tokens dropping under a data axis. Weights come from the JAX tree through
`params_from_numpy`; the JAX reference runs in this process."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jax_moe
from ray_tpu_torch.models import MoEConfig, moe_ffn, moe_param_axes, params_from_numpy
from ray_tpu_torch.models.moe import init_moe_params, moe_param_shapes
from ray_tpu_torch.parallel import MeshSpec, build_mesh, gather_tree, local_placements, shard_tree
from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
from ray_tpu_torch.parallel.sharding import placement, resolve_rules, shard_tensor
from torch_ranks import run_local_ranks

WORLD = 4
# f32: the same products and sums in other orders across frameworks.
TOL = 1e-5


def _config(cf=1.25, **kw):
    base = dict(n_experts=4, top_k=2, d_model=16, d_ff=32, capacity_factor=cf)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _jax_reference(cfg_items, shape=(2, 16, 16)):
    """JAX params (numpy), x, probe r, and y, aux and the gradients of
    sum(y * r) + aux with respect to the params and x."""
    cfg = jax_moe.MoEConfig(**dict(cfg_items))
    params = jax_moe.init_moe_params(cfg, jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), shape)
    r = jax.random.normal(jax.random.PRNGKey(2), shape)

    def objective(p, h):
        y, aux = jax_moe.moe_ffn(p, h, cfg)
        return jnp.sum(y * r) + aux

    y, aux = jax_moe.moe_ffn(params, x, cfg)
    gp, gx = jax.grad(objective, argnums=(0, 1))(params, x)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "x": np.asarray(x), "r": np.asarray(r), "y": np.asarray(y),
            "aux": float(aux), "grads": as_np(gp), "grad_x": np.asarray(gx)}


@pytest.mark.parametrize("cf", [2.0, 1.25, 0.5])
def test_moe_ffn_matches_jax_with_gradients(cf):
    ref = _jax_reference(tuple(sorted(_config(cf).items())))
    params = params_from_numpy(ref["params"], device="cpu")
    for leaf in params.values():
        leaf.requires_grad_(True)
    x = torch.tensor(ref["x"], requires_grad=True)
    y, aux = moe_ffn(params, x, MoEConfig(**_config(cf)))
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux.detach()), ref["aux"], rtol=TOL)
    assert y.dtype == x.dtype and aux.dtype == torch.float32
    objective = torch.sum(y * torch.tensor(ref["r"])) + aux
    grads = torch.autograd.grad(objective, list(params.values()) + [x])
    for (name, g) in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), ref["grads"][name], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(grads[-1].numpy(), ref["grad_x"], atol=TOL, rtol=TOL)


def test_moe_capacity_drops_overflow_tokens():
    """tests/test_moe_dashboard_cli.py:50: a tiny capacity factor drops
    most tokens, whose rows come out zero, as in the JAX call."""
    kw = dict(n_experts=2, top_k=1, d_model=8, d_ff=16, capacity_factor=0.1)
    cfg = jax_moe.MoEConfig(**kw)
    jp = jax_moe.init_moe_params(cfg, jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 8))
    ref, ref_aux = jax_moe.moe_ffn(jp, x, cfg)
    y, aux = moe_ffn(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu"),
                     torch.tensor(np.asarray(x)), MoEConfig(**kw))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=TOL)
    zero_rows = int(torch.sum(torch.all(y[0].abs() < 1e-9, dim=-1)))
    assert zero_rows > 16


def test_moe_tree_carries_over_and_inits_like_jax():
    ref = _jax_reference(tuple(sorted(_config().items())))
    bf16 = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), ref["params"])
    ours = params_from_numpy(bf16, device="cpu")
    cfg = MoEConfig(**_config())
    drawn = init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert moe_param_axes(cfg) == jax_moe.moe_param_axes(jax_moe.MoEConfig(**_config()))
    for name, shape in moe_param_shapes(cfg).items():
        assert tuple(ours[name].shape) == shape == ref["params"][name].shape
        assert ours[name].dtype == torch.bfloat16
        assert torch.equal(ours[name].view(torch.int16),
                           torch.tensor(bf16[name].view(np.int16)))
        assert tuple(drawn[name].shape) == shape and drawn[name].dtype == torch.float32


# -- expert parallel on 4 ranks ------------------------------------------------------

EP_SPECS = [dict(data=2, expert=2), dict(data=1, expert=4), dict(data=1, fsdp=2, expert=2),
            dict(data=1, expert=2, tensor=2)]
EP_CFS = [2.0, 0.5]


def _ep_ranks(rank, cases, out_dir):
    out = {}
    rules = resolve_rules("ep")
    for name, spec, cf, ref in cases:
        mesh = build_mesh(MeshSpec(**spec), device_type="cpu")
        cfg = MoEConfig(**_config(cf))
        local = shard_tree(params_from_numpy(ref["params"], device="cpu"), moe_param_axes(cfg),
                           rules, mesh)
        for leaf in local.values():
            leaf.requires_grad_(True)
        rows = placement(ref["x"].shape, ("act_batch", None, None), rules, mesh_axis_sizes(mesh))
        x = shard_tensor(torch.tensor(ref["x"]), rows, mesh).requires_grad_(True)
        r = shard_tensor(torch.tensor(ref["r"]), rows, mesh)
        y, aux = moe_ffn(local, x, cfg, rules=rules, mesh=mesh)
        *grads, grad_x = torch.autograd.grad(torch.sum(y * r) + aux, list(local.values()) + [x])
        # The leaves are whole over `data`, whose ranks hold other tokens:
        # their gradients sum over it, as the training step sums them.
        for g in grads:
            torch.distributed.all_reduce(g, group=mesh.get_group("data"))
        places = local_placements(moe_param_shapes(cfg), moe_param_axes(cfg), rules, mesh)
        out[name] = {"y": y.detach(), "aux": float(aux), "grad_x": grad_x, "rows": rows,
                     "grads": gather_tree(dict(zip(local, grads)), places, mesh)}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def _case_name(spec, cf):
    return "_".join(f"{k}{v}" for k, v in spec.items()) + f"_cf{cf}"


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    cases = [(_case_name(spec, cf), spec, cf, _jax_reference(tuple(sorted(_config(cf).items()))))
             for spec in EP_SPECS for cf in EP_CFS]
    run_local_ranks(_ep_ranks, WORLD, (cases, str(tmp)), init_file=str(tmp / "rdzv"))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_tokens_drop_at_the_small_capacity_factor():
    """At capacity_factor 0.5 the JAX call drops tokens (their rows differ
    from the call where nothing can drop), so the ep cases below see the
    global queue order decide which."""
    lo = _jax_reference(tuple(sorted(_config(0.5).items())))["y"]
    hi = _jax_reference(tuple(sorted(_config(2.0).items())))["y"]
    changed = np.any(np.abs(lo - hi) > 1e-6, axis=-1)
    assert 0 < changed.sum() < changed.size


@pytest.mark.parametrize("cf", EP_CFS)
@pytest.mark.parametrize("spec", EP_SPECS, ids=[_case_name(s, "")[:-3] for s in EP_SPECS])
def test_expert_parallel_moe_matches_the_unsharded_jax_call(ep_ranks, spec, cf):
    ref = _jax_reference(tuple(sorted(_config(cf).items())))
    data = spec.get("data", 1) * spec.get("fsdp", 1)
    per = ref["x"].shape[0] // data
    for rank, out in enumerate(ep_ranks):
        got = out[_case_name(spec, cf)]
        # The batch's shard index of this rank: data major, fsdp minor,
        # expert and tensor inner (the mesh's row-major rank order).
        inner = WORLD // data
        shard = rank // inner
        rows = slice(shard * per, (shard + 1) * per)
        np.testing.assert_allclose(got["y"].numpy(), ref["y"][rows], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["aux"], ref["aux"], rtol=TOL)
        np.testing.assert_allclose(got["grad_x"].numpy(), ref["grad_x"][rows], atol=TOL, rtol=TOL)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), ref["grads"][name], atol=TOL, rtol=TOL,
                                       err_msg=name)
