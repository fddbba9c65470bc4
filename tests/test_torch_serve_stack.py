"""The port's serve stack: `serve.run` deploys a replica actor holding the
decoder, `@serve.batch` groups its requests, and the handle's requests go
through the router to it, as in
tests/test_serve.py::test_batched_jax_inference; the same deployment
answers through the HTTP proxy; a replica given `num_gpus=1` holds the
runtime's "GPU" until it is deleted.

The JAX tree is carried into the replicas as numpy leaves in the
deployment's init args. This module imports jax and ray_tpu only inside
functions: the deployment classes defined here are pickled by reference,
so each replica imports this module, and the JAX reference runs in the
test process.
"""

import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.models import TransformerConfig, forward, params_from_numpy

N_REQUESTS = 12
# Last-position logits of the port's f32 forward against JAX's (the same
# products and sums in another order).
LOGIT_ATOL = 1e-5


def foreign_modules() -> list:
    """The modules of the JAX package, or of jax, this process has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib"))


class LMServer:
    """A replica holding the tiny decoder on the CPU: next-token prediction
    for a batch of equal-length prompts in one forward. A request is
    {"tokens": [...]}, and {"logits": True} adds the last-position logits
    row to its answer."""

    def __init__(self, params_np):
        self.cfg = TransformerConfig.tiny()
        self.params = params_from_numpy(params_np, device="cpu")
        self.batches = []  # sizes, in the order the batches ran

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=1.0)
    def predict_batch(self, requests):
        batch_id = len(self.batches)
        self.batches.append(len(requests))
        toks = torch.tensor([r["tokens"] for r in requests], dtype=torch.long)
        with torch.no_grad():
            last = forward(self.params, toks, self.cfg)[:, -1, :]
        top2 = last.topk(2, dim=-1).values
        out = []
        for i, r in enumerate(requests):
            answer = {"token": int(last[i].argmax()), "gap": float(top2[i, 0] - top2[i, 1]),
                      "batch": batch_id, "index": i}
            if r.get("logits"):
                answer["logits"] = last[i].numpy().copy()
            out.append(answer)
        return out

    def __call__(self, request):
        return self.predict_batch(request)

    def stats(self):
        return {"batches": list(self.batches), "foreign_modules": foreign_modules()}


@pytest.fixture(scope="module")
def stack():
    """One runtime with one "GPU" (no card: a resource to reserve), the
    serve controller and an HTTP proxy on a free port."""
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    try:
        serve.start(http_options={"host": "127.0.0.1", "port": 0})
        yield
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX package's tiny decoder: its parameter tree as numpy leaves,
    and its forward's last-position logits for a batch of prompts."""
    import jax

    from ray_tpu.models import transformer as jax_tf

    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))

    def last_logits(prompts):
        return np.asarray(jax_tf.forward(params, np.asarray(prompts), cfg))[:, -1, :]

    return jax.tree_util.tree_map(np.asarray, params), last_logits


@pytest.fixture(scope="module")
def lm(stack, jax_lm):
    handle = serve.run(serve.deployment(LMServer, name="lm", max_concurrent_queries=16)
                       .bind(jax_lm[0]))
    yield handle
    serve.delete("lm")


def test_deployed_decoder_answers_with_the_jax_argmax(lm, jax_lm):
    prompts = [[1, 2, 3, i % 32] for i in range(N_REQUESTS)]
    refs = [lm.remote({"tokens": p, "logits": True}) for p in prompts]
    outs = ray_tpu_torch.get(refs, timeout=120)
    ref = jax_lm[1](prompts)
    assert [o["token"] for o in outs] == [int(t) for t in ref.argmax(axis=-1)]
    got = np.stack([o["logits"] for o in outs])
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)
    # Every request has its own place in a batch, and the batcher grouped.
    places = sorted((o["batch"], o["index"]) for o in outs)
    assert len(set(places)) == N_REQUESTS
    stats = ray_tpu_torch.get(lm.stats.remote(), timeout=30)
    assert sum(stats["batches"]) == N_REQUESTS and max(stats["batches"]) > 1
    # Determinism: the same prompt gives the same token.
    a = ray_tpu_torch.get(lm.remote({"tokens": [5, 6, 7]}), timeout=60)
    b = ray_tpu_torch.get(lm.remote({"tokens": [5, 6, 7]}), timeout=60)
    assert a["token"] == b["token"] == int(jax_lm[1]([[5, 6, 7]])[0].argmax())


def _post(url: str, body) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_proxy_answers_with_the_jax_argmax(lm, jax_lm):
    url = serve.get_http_address() + "/lm"
    prompts = [[4, 5, 6, i % 32] for i in range(8)]
    outs, errors = [None] * len(prompts), []

    def call(i):
        try:
            outs[i] = _post(url, {"tokens": prompts[i]})["result"]
        except Exception as e:  # noqa: BLE001 - failed below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert errors == [] and not any(t.is_alive() for t in threads)
    ref = jax_lm[1](prompts)
    assert [o["token"] for o in outs] == [int(t) for t in ref.argmax(axis=-1)]
    top2 = np.sort(ref, axis=-1)[:, -2:]
    np.testing.assert_allclose([o["gap"] for o in outs], top2[:, 1] - top2[:, 0],
                               rtol=0, atol=2 * LOGIT_ATOL)
    assert all("logits" not in o for o in outs)


def test_replica_loads_neither_jax_nor_ray_tpu(lm):
    assert ray_tpu_torch.get(lm.stats.remote(), timeout=30)["foreign_modules"] == []


class GpuHolder:
    def __call__(self, _request=None):
        return "held"


def _free_gpus(expect: float, timeout_s: float = 30.0) -> float:
    deadline = time.monotonic() + timeout_s
    while True:
        free = ray_tpu_torch.available_resources().get("GPU", 0.0)
        if free == expect or time.monotonic() > deadline:
            return free
        time.sleep(0.1)


def test_replica_with_num_gpus_holds_the_gpu_until_deleted(stack):
    assert _free_gpus(1.0) == 1.0
    handle = serve.run(serve.deployment(GpuHolder, name="gpu_holder",
                                        ray_actor_options={"num_gpus": 1}).bind())
    try:
        assert ray_tpu_torch.get(handle.remote(), timeout=60) == "held"
        assert _free_gpus(0.0) == 0.0
        assert serve.status()["gpu_holder"]["config"]["ray_actor_options"] == {"num_gpus": 1}
    finally:
        serve.delete("gpu_holder")
    assert _free_gpus(1.0) == 1.0
