"""The port's sharded training step (`ray_tpu_torch.models.LMTrainContext`
under a mesh) against the JAX package's single-device step, on 4 CPU
processes joined in a gloo group, the port's counterpart of the JAX
package's 8-device virtual CPU mesh.

Every case starts from the same JAX weights (the JAX `init_state(0)` tree,
carried over by `state_from_numpy` and cut into each rank's shards), takes
3 steps on one batch of 8 x 32 tokens and is held to the JAX
`LMTrainContext` with strategy "dp" on one device, the ground truth
`tests/test_models.py::test_train_step_strategies_agree` uses: loss and
gradient norm each step, and the parameters after, gathered back from the
shards. The JAX reference runs in this process; the ranks import no jax
(this module imports it only inside functions).
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import LMTrainContext, TransformerConfig, state_from_numpy
from ray_tpu_torch.parallel import MeshSpec, build_mesh, gather_tree
from torch_ranks import run_local_ranks

WORLD = 4
STEPS = 3
# Loss and gradient norm: one scalar each, summed over ranks, shards and the
# tensor axis's partial products in other orders than on one device (f32).
STEP_RTOL = 1e-5
# Parameters after 3 AdamW steps: f32 rounding of the gradients, as in
# tests/test_torch_train.py (PARAM_ATOL there).
PARAM_ATOL = 1e-5

# (strategy, mesh, masked batch)
CASES = [
    ("dp", dict(data=4), False),
    ("fsdp", dict(data=2, fsdp=2), False),
    ("tp", dict(data=1, tensor=4), False),  # kv heads 2 replicated, vocab 256/4
    ("fsdp_tp", dict(data=1, fsdp=2, tensor=2), False),
    ("sp", dict(data=1, seq=4), False),
    ("sp", dict(data=1, seq=2, tensor=2), False),
    ("ep", dict(data=1, fsdp=2, expert=2), False),
    ("fsdp", dict(data=2, fsdp=2), True),
]
IDS = ["dp", "fsdp", "tp", "fsdp_tp", "sp", "sp_tp", "ep", "fsdp_masked"]


def _batch(masked: bool) -> dict:
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, (8, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if masked:
        batch["mask"] = (rng.random((8, 32)) > 0.3).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_reference(masked: bool):
    """The JAX step on one device: (initial params, [(loss, grad_norm)],
    final params), numpy trees."""
    import jax

    from ray_tpu.models import lm as jax_lm
    from ray_tpu.models import transformer as jax_tf
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh

    ctx = jax_lm.LMTrainContext(
        jax_tf.TransformerConfig.tiny(),
        jax_build_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1]), "dp",
    )
    state = ctx.init_state(0)
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    metrics = []
    for _ in range(STEPS):
        state, m = ctx.train_step(state, _batch(masked))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params0, metrics, jax.tree_util.tree_map(np.asarray, state["params"])


def _train_rank(rank, strategy, spec, params0, batch, out_dir):
    mesh = build_mesh(MeshSpec(**spec), device_type="cpu")
    ctx = LMTrainContext(TransformerConfig.tiny(), mesh, strategy)
    state = state_from_numpy(params0, ctx.config, device="cpu", mesh=mesh, strategy=strategy)
    metrics = []
    for _ in range(STEPS):
        state, m = ctx.train_step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    full = gather_tree(state["params"], ctx.placements, mesh)
    torch.save({"metrics": metrics, "params": full}, f"{out_dir}/rank{rank}.pt")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("strategy,spec,masked", CASES, ids=IDS)
def test_sharded_step_matches_jax_single_device(tmp_path, strategy, spec, masked):
    params0, jax_metrics, jax_params = _jax_reference(masked)
    run_local_ranks(_train_rank, WORLD, (strategy, spec, params0, _batch(masked), str(tmp_path)),
                    init_file=str(tmp_path / "rdzv"))
    theirs = _leaves(jax_params)
    for rank in range(WORLD):
        out = torch.load(tmp_path / f"rank{rank}.pt", weights_only=True)
        for (loss, norm), (jloss, jnorm) in zip(out["metrics"], jax_metrics):
            np.testing.assert_allclose(loss, jloss, rtol=STEP_RTOL)
            np.testing.assert_allclose(norm, jnorm, rtol=STEP_RTOL)
        ours = _leaves(out["params"])
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("strategy", ["pp", "pp_fsdp"])
def test_pipelined_strategies_raise_naming_a9(strategy):
    with pytest.raises(NotImplementedError, match="A9"):
        LMTrainContext(TransformerConfig.tiny(), strategy=strategy, device="cpu")
