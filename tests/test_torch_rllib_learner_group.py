"""The port's `LearnerGroup` on 2 CPU processes joined in a gloo group: the
2-learner V-trace update (each rank on half the env axis, the advantages
standardised by the whole batch's statistics, the gradients averaged) equals
the 1-learner update and the JAX package's `LearnerGroup` at 1 and 2
learners, at `tests/test_rllib.py::test_learner_group_sharded_parity`'s
bounds (rtol 1e-5, atol 1e-6; the loss at 1e-5 relative). The JAX
reference runs in this process (the ranks import no jax: this module
imports it only inside functions)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import learner_state_from_numpy
from ray_tpu_torch.rllib import (
    APPOConfig,
    IMPALAConfig,
    LearnerGroup,
    make_appo_learner,
    make_impala_learner,
)
from torch_ranks import run_local_ranks

WORLD = 2
RTOL, ATOL = 1e-5, 1e-6


def _batch(T=8, N=4):
    """tests/test_rllib.py:235's batch, with rewards, behaviour log-probs
    and cuts that vary, so that the advantages' statistics differ by half."""
    rng = np.random.default_rng(1)
    term = rng.random((T, N)) < 0.1
    return {
        "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(T, N)),
        "action_logp": (-0.7 + 0.3 * rng.normal(size=(T, N))).astype(np.float32),
        "rewards": (1.0 + np.arange(N) * rng.random((T, N))).astype(np.float32),
        "terminateds": term,
        "dones": term | (rng.random((T, N)) < 0.1),
    }


def _learner(algo):
    if algo == "impala":
        return make_impala_learner(IMPALAConfig(), 4, 2, device="cpu")[1]
    return make_appo_learner(APPOConfig(), 4, 2, device="cpu")[1]


def _jax_reference(algo):
    """(initial state, and per learner count the params and total loss of
    the JAX LearnerGroup's update), numpy."""
    import jax

    from ray_tpu.rllib import appo, impala

    if algo == "impala":
        init_state, update_fn = impala.make_impala_learner(impala.IMPALAConfig(), 4, 2)
    else:
        init_state, update_fn = appo.make_appo_learner(appo.APPOConfig(), 4, 2)
    state0 = jax.tree_util.tree_map(np.asarray, init_state(0))
    out = {}
    for n in (1, 2):
        s, m = impala.LearnerGroup(update_fn, n).update(init_state(0), _batch())
        out[n] = (jax.tree_util.tree_map(np.asarray, s["params"]), float(m["total_loss"]))
    return state0, out


def _group_rank(rank, algo, state0, batch, out_dir):
    update = _learner(algo)
    one, m1 = LearnerGroup(update, 1).update(learner_state_from_numpy(state0, device="cpu"), batch)
    two, m2 = LearnerGroup(update, WORLD).update(learner_state_from_numpy(state0, device="cpu"),
                                                 batch)
    with pytest.raises(ValueError, match="not divisible"):
        LearnerGroup(update, WORLD).update(two, {k: v[:, :3] for k, v in batch.items()})
    torch.save({"one": one["params"], "two": two["params"], "opt_two": two["opt_state"],
                "loss_one": float(m1["total_loss"]), "loss_two": float(m2["total_loss"])},
               f"{out_dir}/rank{rank}.pt")


def _pairs(ours, theirs):
    if isinstance(theirs, dict):
        for k in theirs:
            yield from _pairs(ours[k], theirs[k])
    elif isinstance(theirs, (list, tuple)):
        for a, b in zip(ours, theirs):
            yield from _pairs(a, b)
    else:
        yield ours, theirs


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_two_learners_equal_one_and_the_jax_learner_group(tmp_path, algo):
    state0, jax_out = _jax_reference(algo)
    run_local_ranks(_group_rank, WORLD, (algo, state0, _batch(), str(tmp_path)),
                    init_file=str(tmp_path / "rdzv"))
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for a, b in _pairs(outs[0]["two"], outs[1]["two"]):
        assert torch.equal(a, b)  # every rank ends with the same state
    for out in outs:
        for a, b in _pairs(out["two"], out["one"]):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=RTOL,
                                       atol=ATOL)
        for n, key in ((1, "one"), (2, "two")):
            jparams, jloss = jax_out[n]
            for a, b in _pairs(out[key], jparams):
                np.testing.assert_allclose(a.detach().numpy(), b, rtol=RTOL, atol=ATOL)
            assert out[f"loss_{key}"] == pytest.approx(jloss, rel=RTOL)
        assert out["loss_two"] == pytest.approx(out["loss_one"], rel=RTOL)
        assert out["opt_two"]["count"] == 1


def test_a_group_spans_all_its_ranks(tmp_path):
    run_local_ranks(_partial_group_rank, 3, (), init_file=str(tmp_path / "rdzv"))


def _partial_group_rank(rank):
    update = _learner("impala")
    with pytest.raises(ValueError, match="spans every rank"):
        LearnerGroup(update, 2)
    with pytest.raises(ValueError, match="num_learners=4 > ranks"):
        LearnerGroup(update, 4)
