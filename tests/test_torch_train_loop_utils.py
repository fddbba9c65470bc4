"""The port's `ray_tpu_torch.train.torch`: `TorchTrainer(torch_config=...)`,
`TorchConfig`, `prepare_model` and `prepare_data_loader`, on CPU workers
joined by `TorchConfig(device="cpu")` in a gloo group (the source's
`TorchConfig(backend="gloo")`).

tests/test_torch_trainer.py's case on the port, and what the port's
`prepare_model` and `prepare_data_loader` give a worker. On the card,
`prepare_model` places the model on the worker's cuda:0 (`chip_smoke.py`
phase 12). One port runtime serves the file. This module imports jax and
ray_tpu nowhere: its loops are pickled by reference, so each worker
imports it.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.air import ScalingConfig
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

CPU = TorchConfig(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def rt():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _ddp_loop(config):
    import torch
    import torch.distributed as dist
    import torch.nn as nn

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.torch import prepare_model

    assert dist.is_initialized()
    assert dist.get_world_size() == 2
    rank = dist.get_rank()
    assert rank == session.get_world_rank()

    torch.manual_seed(1234 + rank)  # different init per rank pre-DDP
    model = prepare_model(nn.Linear(4, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.05)

    g = torch.Generator().manual_seed(rank)  # different data per rank
    x = torch.randn(64, 4, generator=g)
    w_true = torch.tensor([[1.0, -2.0, 3.0, 0.5]]).T
    y = x @ w_true + 0.1

    first = None
    for step in range(30):
        opt.zero_grad()
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()  # DDP allreduces grads here
        opt.step()
        if first is None:
            first = float(loss)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    session.report(
        {
            "rank": rank,
            "first_loss": first,
            "last_loss": float(loss),
            "params": flat.numpy().tolist(),
        }
    )


def _synced_weights():
    import torch
    import torch.distributed as dist
    import torch.nn as nn

    from ray_tpu_torch.train.torch import prepare_model

    torch.manual_seed(100 + dist.get_rank())
    model = prepare_model(nn.Linear(3, 1))
    # one DDP step syncs gradients; params start broadcast from rank0
    return [p.detach().numpy().tolist() for p in model.parameters()]


def test_torch_ddp_two_workers_sync_params():
    """DDP over gloo: after training, every rank holds IDENTICAL params and
    the loss went down."""
    trainer = TorchTrainer(
        _ddp_loop,
        torch_config=CPU,
        scaling_config=ScalingConfig(num_workers=2),
    )
    result = trainer.fit()
    assert result.error is None
    m = result.metrics
    assert m["last_loss"] < m["first_loss"]

    # Verify identical post-DDP params across BOTH ranks via a second group.
    from ray_tpu_torch.train.backend_executor import BackendExecutor

    ex = BackendExecutor(CPU, ScalingConfig(num_workers=2))
    ex.start()
    try:
        outs = ex.worker_group.execute(_synced_weights, timeout=120)
        # DDP broadcasts rank-0 params at wrap time: ranks must match.
        for a, b in zip(outs[0], outs[1]):
            np.testing.assert_allclose(a, b)
    finally:
        ex.shutdown()


def _one_worker_model(config):
    import torch
    import torch.nn as nn

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.torch import prepare_model

    model = prepare_model(nn.Linear(4, 2))
    session.report({"devices": sorted({str(p.device) for p in model.parameters()}),
                    "type": type(model).__name__,
                    "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "is_ddp": isinstance(model, torch.nn.parallel.DistributedDataParallel)})


def test_prepare_model_on_one_worker_is_on_the_worker_s_device():
    result = TorchTrainer(_one_worker_model, torch_config=CPU,
                          scaling_config=ScalingConfig(num_workers=1)).fit()
    assert result.error is None
    # A CPU worker holds no card: the model stays a plain module on the CPU.
    assert result.metrics["gpu_ids"] == []
    assert result.metrics["devices"] == ["cpu"]
    assert result.metrics["type"] == "Linear" and not result.metrics["is_ddp"]


def _loader_loop(config):
    import torch
    from torch.utils.data import TensorDataset
    from torch.utils.data.distributed import DistributedSampler

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.torch import prepare_data_loader

    ds = TensorDataset(torch.arange(10, dtype=torch.float32))
    loader = prepare_data_loader(ds, batch_size=2, shuffle=False)
    rows = [float(v) for (batch,) in loader for v in batch]
    session.report({"rank": session.get_world_rank(), "rows": rows,
                    "distributed": isinstance(loader.sampler, DistributedSampler)})


def test_prepare_data_loader_gives_each_rank_a_distributed_sampler():
    from ray_tpu_torch.train.backend_executor import BackendExecutor

    ex = BackendExecutor(CPU, ScalingConfig(num_workers=2))
    ex.start()
    try:
        (r0,), (r1,) = ex.run_training(_loader_loop, config={})
    finally:
        ex.shutdown()
    r0, r1 = r0["metrics"], r1["metrics"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["distributed"] and r1["distributed"]
    # Each rank reads its own half of the rows, and together they read all.
    assert len(r0["rows"]) == len(r1["rows"]) == 5
    assert sorted(r0["rows"] + r1["rows"]) == [float(i) for i in range(10)]


def test_train_torch_config_is_the_backend_s():
    """The port defines one TorchConfig: train.torch names the backend's."""
    from ray_tpu_torch.train import TorchConfig as BackendTorchConfig
    from ray_tpu_torch.train.torch import TorchTrainer as TrainTorchTrainer

    assert TorchConfig is BackendTorchConfig
    trainer = TrainTorchTrainer(_one_worker_model, torch_config=CPU)
    assert trainer.backend_config is CPU
    assert trainer.scaling_config.worker_resources().get("GPU") is None
    # The default binds each worker to a card: it reserves one "GPU" a worker.
    default = TrainTorchTrainer(_one_worker_model)
    assert default.backend_config.device == "cuda"
    assert default.scaling_config.worker_resources()["GPU"] == 1
