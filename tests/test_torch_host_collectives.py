"""The port's host `CollectiveGroup` (`ray_tpu_torch.parallel.collectives`):
numpy collectives among actors of the port's runtime, through a named
coordinator actor, on the CPU only (it touches no card).

tests/test_multihost.py's two host-collective cases run on the port; each
reduce op equals the JAX package's table on the same seeded inputs; two
trainer workers of a `TorchTrainer` allreduce their ranks; and the host
half is its source's lines, package name rewritten. One port runtime serves
the file. This module imports jax and ray_tpu only inside functions: the
train loop defined here is pickled by reference, so each worker imports it.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.air import ScalingConfig
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.train import TorchConfig, TorchTrainer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def rt():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _CollectiveRank:
    """One rank living in its own worker process (tests/test_multihost.py's,
    with the group's name an argument: the coordinator of a group outlives
    the test that made it, and this file shares one runtime)."""

    def __init__(self, world_size, rank, timeout_s=30.0, group_name="hosttest"):
        from ray_tpu_torch.parallel.collectives import init_collective_group

        self.group = init_collective_group(world_size, rank, group_name=group_name)
        self.group.timeout_s = timeout_s
        self.rank = rank

    def run_all(self):
        g = self.group
        out = {}
        out["allreduce"] = g.allreduce(np.full(4, self.rank + 1.0)).tolist()
        out["allgather"] = [a.tolist() for a in g.allgather(np.array([self.rank]))]
        out["broadcast"] = g.broadcast(
            np.array([42.0]) if self.rank == 0 else None, src_rank=0
        ).tolist()
        out["reducescatter"] = g.reducescatter(np.arange(4, dtype=np.float64)).tolist()
        g.barrier()
        if self.rank == 0:
            g.send(np.array([7.0]), dst_rank=1)
        elif self.rank == 1:
            out["recv"] = g.recv(src_rank=0).tolist()
        return out

    def lonely_allreduce(self):
        return self.group.allreduce(np.ones(1)).tolist()


def test_host_collective_group_full_surface():
    """allreduce/allgather/broadcast/reducescatter/barrier/send-recv across
    3 real worker processes, blocking (no poll) on the coordinator."""
    world = 3
    ranks = [_CollectiveRank.remote(world, r) for r in range(world)]
    outs = ray_tpu_torch.get([r.run_all.remote() for r in ranks], timeout=60)
    for out in outs:
        assert out["allreduce"] == [6.0] * 4  # (1+2+3)
        assert out["allgather"] == [[0], [1], [2]]
        assert out["broadcast"] == [42.0]
    # reducescatter: sum = [0,3,6,9] split 3 ways (sizes 2/1/1)
    assert outs[0]["reducescatter"] == [0.0, 3.0]
    assert outs[1]["reducescatter"] == [6.0]
    assert outs[2]["reducescatter"] == [9.0]
    assert outs[1]["recv"] == [7.0]
    for r in ranks:
        ray_tpu_torch.kill(r)


def test_host_collective_times_out_on_missing_peer():
    """A collective whose peer never contributes must raise, not hang
    (the dead-peer contract; parked server-side with a timeout)."""
    lonely = _CollectiveRank.remote(2, 0, 2.0, "lonely")  # world 2, peer never joins
    with pytest.raises(Exception, match="timed out"):
        ray_tpu_torch.get(lonely.lonely_allreduce.remote(), timeout=40)
    ray_tpu_torch.kill(lonely)


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min", "mean"])
def test_reduce_op_equals_the_jax_package_s(op):
    from ray_tpu.parallel.collectives import _REDUCE_OPS as SOURCE_OPS

    assert set(collectives._REDUCE_OPS) == set(SOURCE_OPS)
    parts = [np.random.default_rng(seed).standard_normal((3, 5)) for seed in range(4)]
    got = collectives._REDUCE_OPS[op](parts)
    want = SOURCE_OPS[op](parts)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _allreduce_ranks_loop(config):
    """Each trainer worker joins a host group of the workers and allreduces
    its rank, through the group and through the module's functions."""
    from ray_tpu_torch import parallel, train

    rank, world = train.get_world_rank(), train.get_world_size()
    group = parallel.init_collective_group(world, rank, group_name=config["group"])
    by_group = group.allreduce(np.array([float(rank)]))
    by_name = parallel.allreduce(np.array([rank + 1.0]), group_name=config["group"], op="max")
    gathered = parallel.allgather(np.array([rank]), group_name=config["group"])
    parallel.barrier(group_name=config["group"])
    parallel.destroy_collective_group(config["group"])
    train.report({"rank": rank, "sum": by_group.tolist(), "max": by_name.tolist(),
                  "gathered": [a.tolist() for a in gathered]})


def test_collective_group_in_two_trainer_workers():
    trainer = TorchTrainer(
        _allreduce_ranks_loop,
        train_loop_config={"group": "trainer_ranks"},
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=TorchConfig(device="cpu"),
    )
    result = trainer.fit()
    assert result.error is None
    m = result.metrics
    assert m["rank"] == 0
    assert m["sum"] == [1.0] and m["max"] == [2.0] and m["gathered"] == [[0], [1]]


def test_host_half_is_its_source_s_lines():
    """The host half (the numpy ops table through destroy_collective_group)
    is the JAX package's, package name rewritten, line for line."""
    src = (REPO / "ray_tpu" / "parallel" / "collectives.py").read_text()
    start, end = src.index("_REDUCE_OPS = {"), src.index("# -- device-side")
    host = re.sub(r"\bray_tpu\b", "ray_tpu_torch", src[start:end]).rstrip()
    port = Path(collectives.__file__).read_text()
    assert host in port
    assert len(host.splitlines()) > 250
