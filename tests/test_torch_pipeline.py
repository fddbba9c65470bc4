"""The port's pipeline schedules (`ray_tpu_torch.parallel.pipeline`) against
the JAX package's (`ray_tpu.parallel.pipeline`), mirroring
`tests/test_pipeline.py`: GPipe's forward and gradients against sequential
stages and the JAX `pipeline_apply`, 1F1B against the JAX
`pipeline_train_step_1f1b` and the port's GPipe, the microbatch counts,
1F1B's memory against GPipe's, and the one-process schedule against the
same schedule on 4 ranks.

The multi-rank runs are 4 CPU processes joined in a gloo group
(`tests/torch_ranks.py`); the JAX references run in this process on its
virtual CPU devices and hand their inputs to the ranks as numpy.
"""

import functools
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel import pipeline as jax_pipeline
from ray_tpu_torch.parallel import MeshSpec, build_mesh, pipeline_apply, pipeline_train_step_1f1b
from ray_tpu_torch.parallel import pipeline as port_pipeline
from ray_tpu_torch.parallel.sharding import shard_tensor
from torch_ranks import run_local_ranks

WORLD = 4
# f32, the same products summed in other orders across frameworks.
TOL = 1e-5
# (P, D, B, M) of the toy stage tanh(x @ w + b), as in tests/test_pipeline.py.
P_, D, B = 4, 8, 16


def _stage_jax(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _mse_jax(y, t):
    return jnp.mean((y - t) ** 2)


def _mse(y, t):
    return torch.mean((y - t) ** 2)


def _sequential(stacked, x):
    for i in range(stacked["w"].shape[0]):
        x = _stage({"w": stacked["w"][i], "b": stacked["b"][i]}, x)
    return x


@functools.lru_cache(maxsize=None)
def _inputs(n_stages: int, d: int = D, b: int = B, scale: float = 0.5):
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    stacked = {"w": jax.random.normal(k1, (n_stages, d, d)) * scale,
               "b": jax.random.normal(k2, (n_stages, d)) * 0.1}
    x = jax.random.normal(k3, (b, d))
    tgt = jax.random.normal(k4, (b, d))
    return stacked, x, tgt


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree, grad=False):
    return {k: torch.tensor(np.asarray(v)).requires_grad_(grad) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _jax_reference(spec_items, m_gpipe: int, m_1f1b: int):
    """On the JAX mesh of `spec`: pipeline_apply's output, the gradients of
    sum(y**2) through it (params and x), and the 1F1B step's loss and
    gradients."""
    spec = dict(spec_items)
    mesh = jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:WORLD])
    stacked, x, tgt = _inputs(spec["pipeline"])
    y = jax.jit(lambda p, h: jax_pipeline.pipeline_apply(
        _stage_jax, p, h, mesh, n_microbatches=m_gpipe))(stacked, x)
    grads = jax.jit(jax.grad(lambda p, h: jnp.sum(jax_pipeline.pipeline_apply(
        _stage_jax, p, h, mesh, n_microbatches=m_gpipe) ** 2), argnums=(0, 1)))(stacked, x)
    loss, g1 = jax.jit(lambda p: jax_pipeline.pipeline_train_step_1f1b(
        _stage_jax, _mse_jax, p, x, tgt, mesh, n_microbatches=m_1f1b))(stacked)
    return {"y": np.asarray(y), "grads": (_np_tree(grads[0]), np.asarray(grads[1])),
            "loss_1f1b": float(loss), "grads_1f1b": _np_tree(g1)}


# -- the microbatch count ------------------------------------------------------


def _warned(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught]


def test_feasible_microbatches_match_jax_with_the_warning():
    for b in range(1, 41):
        for requested in (1, 2, 3, 4, 5, 8, 16, 32):
            ours = _warned(lambda: port_pipeline._feasible_microbatches(b, requested))
            theirs = _warned(lambda: jax_pipeline._feasible_microbatches(b, requested))
            assert ours == theirs, (b, requested)


@pytest.mark.parametrize("shape", [dict(data=2, pipeline=4), dict(data=1, pipeline=2, fsdp=2),
                                   dict(data=3, pipeline=2), dict(data=1, pipeline=8)])
def test_derived_microbatches_match_jax(shape):
    """The JAX function reads the mesh's shape and the global batch; the
    port's ranks hold their local batch."""
    mesh = SimpleNamespace(shape={**dict(data=1, fsdp=1, pipeline=1), **shape})
    batch_axes = tuple(a for a in ("data", "fsdp") if mesh.shape[a] > 1)
    ranks = int(np.prod([mesh.shape[a] for a in batch_axes]))
    for local in range(1, 70):
        x = np.zeros((local * ranks, 1))
        theirs = jax_pipeline._derive_microbatches(mesh, x, batch_axes, shape["pipeline"])
        assert port_pipeline._derive_microbatches(local, shape["pipeline"]) == theirs, local


# -- all stages in one process ---------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 32])
def test_one_process_gpipe_matches_sequential_and_jax(m):
    """Every feasible and infeasible count (3 -> 2, 32 -> 16) gives the
    sequential result; m=4 also against JAX's pipeline_apply."""
    stacked, x, _ = _inputs(P_)
    params, xt = _torch_tree(stacked, grad=True), torch.tensor(np.asarray(x), requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        y = pipeline_apply(_stage, params, xt, n_microbatches=m)
    ref = _sequential(params, xt)
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(), atol=TOL, rtol=TOL)
    ours = torch.autograd.grad(torch.sum(y ** 2), [params["w"], params["b"], xt])
    seq = torch.autograd.grad(torch.sum(ref ** 2), [params["w"], params["b"], xt])
    for a, b in zip(ours, seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
    if m == 4:
        jref = _jax_reference((("data", 1), ("pipeline", 4)), 4, 8)
        np.testing.assert_allclose(y.detach().numpy(), jref["y"], atol=TOL, rtol=TOL)
        for a, b in zip(ours, [jref["grads"][0]["w"], jref["grads"][0]["b"], jref["grads"][1]]):
            np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=TOL)


def test_one_process_1f1b_matches_jax_and_gpipe():
    stacked, x, tgt = _inputs(P_)
    params = _torch_tree(stacked, grad=True)
    xt, tt = torch.tensor(np.asarray(x)), torch.tensor(np.asarray(tgt))
    loss, grads = pipeline_train_step_1f1b(_stage, _mse, params, xt, tt, n_microbatches=8)
    jref = _jax_reference((("data", 1), ("pipeline", 4)), 4, 8)
    np.testing.assert_allclose(float(loss), jref["loss_1f1b"], rtol=TOL)
    gp_loss = _mse(pipeline_apply(_stage, params, xt, n_microbatches=8), tt)
    gp = torch.autograd.grad(gp_loss, [params["w"], params["b"]])
    np.testing.assert_allclose(float(loss), float(gp_loss.detach()), rtol=TOL)
    for k, g in zip(("w", "b"), gp):
        np.testing.assert_allclose(grads[k].numpy(), jref["grads_1f1b"][k], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=TOL, rtol=TOL)


def test_gpipe_under_no_grad_keeps_no_graph():
    stacked, x, _ = _inputs(P_)
    params = _torch_tree(stacked, grad=True)
    with torch.no_grad():
        y = pipeline_apply(_stage, params, torch.tensor(np.asarray(x)), n_microbatches=4)
    assert y.grad_fn is None and not y.requires_grad


# -- on 4 ranks --------------------------------------------------------------------


def _peak_saved_bytes(fn):
    """fn()'s result and the peak bytes of the tensors autograd graphs held
    saved for their backward while it ran (a saved tensor counts until its
    graph is freed)."""
    state = {"live": 0, "peak": 0}

    class Held:
        def __init__(self, t):
            self.t, self.n = t, t.numel() * t.element_size()
            state["live"] += self.n
            state["peak"] = max(state["peak"], state["live"])

        def __del__(self):
            state["live"] -= self.n

    with torch.autograd.graph.saved_tensors_hooks(Held, lambda held: held.t):
        out = fn()
    return out, state["peak"]


SPECS = [dict(data=2, pipeline=2), dict(data=1, pipeline=4)]
M_GPIPE, M_1F1B = 4, 8


def _local(tree, mesh):
    """This rank's stage of each stacked leaf, and of x its batch rows."""
    return {k: shard_tensor(torch.tensor(v), (("pipeline",),) + ((),) * (v.ndim - 1), mesh)
            for k, v in tree.items()}


def _rows(x, mesh):
    return shard_tensor(torch.tensor(x), (("data",) if mesh.shape[0] > 1 else (), ()), mesh)


def _pipeline_ranks(rank, cases, memory_case, out_dir):
    out = {}
    for name, spec, stacked, x, tgt in cases:
        mesh = build_mesh(MeshSpec(**spec), device_type="cpu")
        params = {k: v.requires_grad_() for k, v in _local(stacked, mesh).items()}
        xt = _rows(x, mesh).requires_grad_()
        y = pipeline_apply(_stage, params, xt, mesh, n_microbatches=M_GPIPE)
        grads = torch.autograd.grad(torch.sum(y ** 2), [params["w"], params["b"], xt])
        tt = _rows(tgt, mesh)
        loss, g1 = pipeline_train_step_1f1b(_stage, _mse, params, xt.detach(), tt, mesh,
                                            n_microbatches=M_1F1B)
        gp_loss = _mse(pipeline_apply(_stage, params, xt.detach(), mesh, n_microbatches=M_1F1B),
                       tt)
        # GPipe's gradients, averaged over the batch axis as 1F1B's are.
        gp = [g / mesh.shape[0] for g in torch.autograd.grad(gp_loss, [params["w"], params["b"]])]
        for g in gp:
            torch.distributed.all_reduce(g, group=mesh.get_group("data"))
        out[name] = {"y": y.detach(), "grads": [g.detach() for g in grads],
                     "loss_1f1b": float(loss), "grads_1f1b": g1,
                     "gpipe_loss": float(gp_loss), "gpipe_grads": gp}
        if name == "pipeline4":
            # The same schedule with all 4 stages in this process.
            full = {k: torch.tensor(v).requires_grad_() for k, v in stacked.items()}
            xf = torch.tensor(x).requires_grad_()
            yf = pipeline_apply(_stage, full, xf, n_microbatches=M_GPIPE)
            gf = torch.autograd.grad(torch.sum(yf ** 2), [full["w"], full["b"], xf])
            lf, g1f = pipeline_train_step_1f1b(_stage, _mse, full, xf.detach(),
                                               torch.tensor(tgt), n_microbatches=M_1F1B)
            out["one_process"] = {"y": yf.detach(), "grads": [g.detach() for g in gf],
                                  "loss_1f1b": float(lf), "grads_1f1b": g1f}
    # 1F1B's memory against GPipe's at M = 32 (tests/test_pipeline.py:133).
    stacked, x, tgt = memory_case
    mesh = build_mesh(MeshSpec(data=1, pipeline=4), device_type="cpu")
    params = {k: v.requires_grad_() for k, v in _local(stacked, mesh).items()}
    xt, tt = torch.tensor(x), torch.tensor(tgt)
    _, gpipe_peak = _peak_saved_bytes(lambda: torch.autograd.grad(
        _mse(pipeline_apply(_stage, params, xt, mesh, n_microbatches=32), tt),
        [params["w"], params["b"]]))
    _, f1b_peak = _peak_saved_bytes(lambda: pipeline_train_step_1f1b(
        _stage, _mse, params, xt, tt, mesh, n_microbatches=32))
    out["saved_peak"] = (gpipe_peak, f1b_peak, x.nbytes // 32)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    cases = []
    for spec in SPECS:
        stacked, x, tgt = _inputs(spec["pipeline"])
        cases.append((f"pipeline{spec['pipeline']}", spec, _np_tree(stacked), np.asarray(x),
                      np.asarray(tgt)))
    stacked, x, tgt = _inputs(4, d=256, b=64, scale=0.05)
    memory_case = (_np_tree(stacked), np.asarray(x), np.asarray(tgt))
    run_local_ranks(_pipeline_ranks, WORLD, (cases, memory_case, str(tmp)),
                    init_file=str(tmp / "rdzv"))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rank_stage(rank, spec):
    """(pipeline stage, data shard) of a rank: pipeline inner to data."""
    return rank % spec["pipeline"], rank // spec["pipeline"]


@pytest.mark.parametrize("spec", SPECS, ids=["data2_pipeline2", "pipeline4"])
def test_gpipe_on_ranks_matches_sequential_and_jax(ranks, spec):
    stacked, x, _ = _inputs(spec["pipeline"])
    params = _torch_tree(stacked, grad=True)
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    ref = _sequential(params, xt)
    seq = torch.autograd.grad(torch.sum(ref ** 2), [params["w"], params["b"], xt])
    jref = _jax_reference(tuple(sorted(spec.items())), M_GPIPE, M_1F1B)
    rows = B // spec["data"]
    for rank, out in enumerate(ranks):
        stage, shard = _rank_stage(rank, spec)
        r = slice(shard * rows, (shard + 1) * rows)
        got = out[f"pipeline{spec['pipeline']}"]
        for want in (ref.detach().numpy(), jref["y"]):
            np.testing.assert_allclose(got["y"].numpy(), want[r], atol=TOL, rtol=TOL)
        # Parameter gradients of this rank's rows; x's on every stage.
        gw, gb, gx = got["grads"]
        np.testing.assert_allclose(gx.numpy(), seq[2].numpy()[r], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(gx.numpy(), jref["grads"][1][r], atol=TOL, rtol=TOL)
        if spec["data"] == 1:
            for ours, k, s in ((gw, "w", seq[0]), (gb, "b", seq[1])):
                np.testing.assert_allclose(ours[0].numpy(), s[stage].numpy(), atol=TOL, rtol=TOL)
                np.testing.assert_allclose(ours[0].numpy(), jref["grads"][0][k][stage],
                                           atol=TOL, rtol=TOL)
    if spec["data"] > 1:  # the data shards' gradients sum to the whole batch's
        for i, k in ((0, "w"), (1, "b")):
            for stage in range(spec["pipeline"]):
                total = sum(out[f"pipeline{spec['pipeline']}"]["grads"][i][0]
                            for rank, out in enumerate(ranks)
                            if _rank_stage(rank, spec)[0] == stage)
                np.testing.assert_allclose(total.numpy(), jref["grads"][0][k][stage],
                                           atol=TOL, rtol=TOL)


@pytest.mark.parametrize("spec", SPECS, ids=["data2_pipeline2", "pipeline4"])
def test_1f1b_on_ranks_matches_jax_and_gpipe(ranks, spec):
    jref = _jax_reference(tuple(sorted(spec.items())), M_GPIPE, M_1F1B)
    for rank, out in enumerate(ranks):
        stage, _ = _rank_stage(rank, spec)
        got = out[f"pipeline{spec['pipeline']}"]
        for loss in (jref["loss_1f1b"], got["gpipe_loss"] if spec["data"] == 1 else None):
            if loss is not None:
                np.testing.assert_allclose(got["loss_1f1b"], loss, rtol=TOL)
        for i, k in enumerate(("w", "b")):
            ours = got["grads_1f1b"][k][0].numpy()
            np.testing.assert_allclose(ours, jref["grads_1f1b"][k][stage], atol=TOL, rtol=TOL)
            np.testing.assert_allclose(ours, got["gpipe_grads"][i][0].numpy(), atol=TOL, rtol=TOL)


def test_one_process_schedule_is_the_ranks_schedule_bit_for_bit(ranks):
    """All 4 stages in one process against the 4-rank schedule: the same
    code path with the hops as hand-offs, so the same bits."""
    one = ranks[0]["one_process"]
    for rank, out in enumerate(ranks):
        got = out["pipeline4"]
        assert torch.equal(got["y"], one["y"])
        assert torch.equal(got["grads"][2], one["grads"][2])
        for i in range(2):
            assert torch.equal(got["grads"][i][0], one["grads"][i][rank])
        assert got["loss_1f1b"] == one["loss_1f1b"]
        for k in ("w", "b"):
            assert torch.equal(got["grads_1f1b"][k][0], one["grads_1f1b"][k][rank])


def test_1f1b_keeps_less_saved_for_backward_than_gpipe(ranks):
    """At M = 32 (P = 4, D = 256, 64 rows): GPipe keeps every microbatch's
    graph until its backward; 1F1B at most one graph at a time, beside its
    ring of at most 2P - 1 microbatch inputs, which is counted with it."""
    for out in ranks:
        gpipe, f1b, microbatch_bytes = out["saved_peak"]
        assert f1b + (2 * 4 - 1) * microbatch_bytes < gpipe, (f1b, gpipe)
