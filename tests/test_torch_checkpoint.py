"""The port's Checkpoint (`ray_tpu_torch.air.checkpoint`): sharded saves on
4 CPU processes joined in a gloo group, each rank writing its own shards
through `torch.distributed.checkpoint` with no gather, restored onto other
layouts; and an RL learner's state through the dict and directory forms.
Restores are bitwise: a checkpoint moves bits, it computes nothing."""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.air import checkpoint as ckpt_mod
from ray_tpu_torch.models import LMTrainContext, TransformerConfig
from ray_tpu_torch.parallel import MeshSpec, build_mesh
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.sharding import shard_tensor, tree_leaves
from ray_tpu_torch.rllib import EnvRunner, PPOConfig, SampleBatch
from ray_tpu_torch.rllib import ppo
from ray_tpu_torch.rllib.sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS
from torch_ranks import run_local_ranks

WORLD = 4
W_SHAPE = (64, 64)


class _NoGather:
    """Inside it, the port's gathers raise and the pickle writes are
    counted: a sharded save must gather nothing, and one rank writes the
    pickles."""

    def __enter__(self):
        self.saved = (sharding.gather_tensor, sharding.all_gather_dim, ckpt_mod._write_pickle)
        self.pickles = 0

        def boom(*_, **__):
            raise AssertionError("a rank gathered during the save")

        def count(path, obj):
            self.pickles += 1
            self.saved[2](path, obj)

        sharding.gather_tensor = sharding.all_gather_dim = boom
        ckpt_mod._write_pickle = count
        return self

    def __exit__(self, *exc):
        sharding.gather_tensor, sharding.all_gather_dim, ckpt_mod._write_pickle = self.saved


def _no_gather_rank(rank, out_dir):
    """tests/test_train.py::test_sharded_checkpoint_no_gather on a 2 x 2
    (data, fsdp) mesh: w split over fsdp, replicated over data."""
    mesh = build_mesh(MeshSpec(data=2, fsdp=2), device_type="cpu")
    place = {"w": (("fsdp",), ())}
    full = torch.arange(float(np.prod(W_SHAPE))).reshape(W_SHAPE)
    state = {"w": shard_tensor(full, place["w"], mesh), "step": torch.ones(())}
    with _NoGather() as watch:
        # A save with no extra keys must be readable too.
        bare = Checkpoint.from_torch_state_sharded(dict(state), f"{out_dir}/bare", mesh, place)
        ckpt = Checkpoint.from_torch_state_sharded(state, f"{out_dir}/ck", mesh, place, tag="x")
    assert watch.pickles == (4 if rank == 0 else 0)  # the tree and the extras, twice
    assert torch.equal(bare.get_torch_state()["w"], full)
    assert ckpt._dir is not None  # lightweight to ship: a directory reference
    restored = ckpt.get_torch_state(placements={"w": place["w"], "step": ()}, mesh=mesh)
    assert torch.equal(restored["w"], state["w"]) and restored["w"].shape == (32, 64)
    assert torch.equal(restored["step"], torch.ones(()))
    # Restored under another split: w's columns over data.
    other = ckpt.get_torch_state(placements={"w": ((), ("data",))}, mesh=mesh)
    assert torch.equal(other["w"], shard_tensor(full, ((), ("data",)), mesh))
    assert ckpt.to_dict()["tag"] == "x"
    assert torch.equal(ckpt.to_dict()["torch_state"]["w"], full)
    # DCP, the one pickle writer and the barrier are the default group's:
    # a mesh over some of its ranks is refused, on save and on load.
    part = type("Mesh", (), {"size": lambda self: 2})()
    with pytest.raises(ValueError, match="a mesh over all of them"):
        Checkpoint.from_torch_state_sharded(state, f"{out_dir}/part", part, place)
    with pytest.raises(ValueError, match="a mesh over all of them"):
        ckpt.get_torch_state(placements=place, mesh=part)


def test_sharded_checkpoint_no_gather(tmp_path):
    run_local_ranks(_no_gather_rank, WORLD, (str(tmp_path),), init_file=str(tmp_path / "rdzv"))
    # Each rank wrote its own shard, and the shard its data replica holds
    # too was written once: about one w in all, never a whole w on a rank.
    sizes = [os.path.getsize(tmp_path / "ck" / "state" / f"__{r}_0.distcp") for r in range(WORLD)]
    w_bytes = 4 * np.prod(W_SHAPE)
    assert max(sizes) < 0.75 * w_bytes, sizes
    assert sum(sizes) < 1.5 * w_bytes, sizes


STRATEGY_MESHES = {
    "dp": dict(data=4),
    "tp": dict(data=1, tensor=4),
    "fsdp_tp": dict(data=1, fsdp=2, tensor=2),
    "fsdp": dict(data=2, fsdp=2),
}


def _batch():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, (8, 33)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _gathered(ctx, state):
    """A copy of the whole state from a context's shards (the step updates
    the state in place): params, moments (lists in the params' leaf order),
    count and step."""
    places = tree_leaves(ctx.placements)
    opt = state["opt_state"]

    def whole(t, p):
        return sharding.gather_tensor(t, p, ctx.mesh).clone()

    return {
        "params": sharding.tree_map(whole, state["params"], ctx.placements),
        "mu": [whole(t, p) for t, p in zip(opt["mu"], places)],
        "nu": [whole(t, p) for t, p in zip(opt["nu"], places)],
        "count": opt["count"], "step": state["step"],
    }


def _assert_bitwise(a, b):
    assert a["count"] == b["count"] and a["step"] == b["step"]
    for x, y in zip(tree_leaves([a["params"], a["mu"], a["nu"]]),
                    tree_leaves([b["params"], b["mu"], b["nu"]])):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _restore_rank(rank, path):
    cfg = TransformerConfig.tiny()
    ctx = LMTrainContext(cfg, build_mesh(MeshSpec(**STRATEGY_MESHES["fsdp"]), device_type="cpu"),
                         "fsdp")
    state, _ = ctx.train_step(ctx.init_state(0), _batch())  # moments and count nonzero
    with _NoGather():
        ckpt = Checkpoint.from_torch_state_sharded(state, path, ctx.mesh, ctx.state_placements())
    saved = _gathered(ctx, state)
    unbroken, m_unbroken = ctx.train_step(state, _batch())
    for strategy, spec in STRATEGY_MESHES.items():
        ctx2 = LMTrainContext(cfg, build_mesh(MeshSpec(**spec), device_type="cpu"), strategy)
        restored = ckpt.get_torch_state(placements=ctx2.state_placements(), mesh=ctx2.mesh)
        assert all(p.requires_grad for p in tree_leaves(restored["params"]))
        _assert_bitwise(_gathered(ctx2, restored), saved)
        if strategy == "fsdp":  # a further step from the restored state
            resumed, m_resumed = ctx2.train_step(restored, _batch())
            assert torch.equal(m_resumed["loss"], m_unbroken["loss"])
            _assert_bitwise(_gathered(ctx2, resumed), _gathered(ctx, unbroken))


def test_fsdp_checkpoint_restores_under_dp_tp_and_fsdp_tp(tmp_path):
    """A tiny LMTrainContext state saved under fsdp (data=2, fsdp=2) after a
    step: restored under dp, tp and fsdp_tp it gathers to the saved state
    bit for bit, and under fsdp a step from it equals the unbroken run's."""
    run_local_ranks(_restore_rank, WORLD, (str(tmp_path / "ck"),),
                    init_file=str(tmp_path / "rdzv"))


def test_placements_must_follow_the_mesh_order():
    """DTensor splits a dim over several mesh dims major-first in the mesh's
    order; a placement listing them otherwise would restore rows in the
    wrong place, so it is refused."""
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "fsdp", "tensor")})()
    assert [str(p) for p in ckpt_mod._dtensor_placements((("data", "fsdp"), ("tensor",)), mesh)] \
        == ["S(0)", "S(0)", "S(1)"]
    with pytest.raises(ValueError, match="mesh's order"):
        ckpt_mod._dtensor_placements((("fsdp", "data"),), mesh)


# -- an RL learner's state -----------------------------------------------------------


def _ppo_setup():
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_runner=4, rollout_length=16)
           .debugging(seed=3))
    runner = EnvRunner(cfg.env, 4, 16, seed=1003, device="cpu")
    init_state, update = ppo._make_learner(cfg, 4, 2, device="cpu")
    return runner, init_state, update


def _train(runner, state, update):
    batch = SampleBatch(runner.sample(state["params"])["batch"])
    return update(state, {k: batch[k] for k in (OBS, ACTIONS, LOGPS, ADVANTAGES, RETURNS)})


def test_ppo_learner_state_round_trips_and_continues_bitwise(tmp_path):
    """tests/test_rllib.py::test_ppo_checkpoint_roundtrip's path in the
    port: params, Adam moments and the permutations' generator go through
    Checkpoint.from_dict -> to_directory -> from_directory, and the restored
    learner's next update equals the unbroken one's bit for bit."""
    runner, init_state, update = _ppo_setup()
    state, _ = _train(runner, init_state(3), update)
    path = Checkpoint.from_dict({"torch_state": state, "iteration": 1}).to_directory(
        str(tmp_path / "ckpt"))
    restored_ckpt = Checkpoint.from_directory(path)
    assert restored_ckpt.to_dict()["iteration"] == 1
    restored = restored_ckpt.get_torch_state(target=init_state(99))
    batch = SampleBatch(runner.sample(state["params"])["batch"])
    cols = {k: batch[k] for k in (OBS, ACTIONS, LOGPS, ADVANTAGES, RETURNS)}
    a, ma = update(state, cols)
    b, mb = update(restored, cols)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(tree_leaves([a["params"], a["opt_state"]["mu"], a["opt_state"]["nu"]]),
                    tree_leaves([b["params"], b["opt_state"]["mu"], b["opt_state"]["nu"]])):
        assert torch.equal(x, y)
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 8  # 2 updates x 4 epochs


def test_torch_state_checkpoint_is_a_copy(tmp_path):
    """from_torch_state keeps host copies: training on after it changes
    neither the checkpoint nor a state restored from it; its directory
    form restores whole on the CPU."""
    runner, init_state, update = _ppo_setup()
    state = init_state(5)
    ckpt = Checkpoint.from_torch_state(state, iteration=0)
    before = [t.clone() for t in tree_leaves(state["params"])]
    restored = ckpt.get_torch_state()
    _train(runner, state, update)
    assert not torch.equal(tree_leaves(state["params"])[0], before[0])
    for t, b in zip(tree_leaves(ckpt.get_torch_state()["params"]), before):
        assert torch.equal(t, b) and t.requires_grad
    assert torch.equal(tree_leaves(restored["params"])[0], before[0])
    with ckpt.as_directory() as d:
        whole = Checkpoint.from_directory(d).get_torch_state()
        assert isinstance(whole["rng"], torch.Generator)
        for t, b in zip(tree_leaves(whole["params"]), before):
            assert torch.equal(t, b)
    assert not os.path.exists(d)
    with pytest.raises(ValueError, match="no torch state"):
        Checkpoint.from_dict({"iteration": 0}).get_torch_state()


def test_restore_into_a_target_of_another_tree_raises(tmp_path):
    """A target whose lists are longer or shorter than the saved ones would
    restore a prefix of the state: it is refused, in dict and directory
    form."""
    saved = {"mu": [torch.ones(3), torch.zeros(2)], "count": 1}
    ckpt = Checkpoint.from_torch_state(saved)
    on_disk = Checkpoint.from_directory(ckpt.to_directory(str(tmp_path / "ck")))
    for form in (ckpt, on_disk):
        for mu in ([torch.empty(3)], [torch.empty(3), torch.empty(2), torch.empty(1)]):
            with pytest.raises(ValueError, match=f"a list of {len(mu)} where the checkpoint "
                                                 "holds 2"):
                form.get_torch_state(target={"mu": mu, "count": 0})
        back = form.get_torch_state(target={"mu": [torch.empty(3), torch.empty(2)], "count": 0})
        assert back["count"] == 1 and torch.equal(back["mu"][0], torch.ones(3))
