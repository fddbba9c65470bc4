"""The port's AIR preprocessors and BatchPredictor: the cases of
tests/test_air_preprocess_predict.py against the port's copies, and a
decoder `Predictor` that loads the JAX package's tiny tree, carried over
into a port `Checkpoint`, in two predictor actors and gives JAX's next
tokens for a `Dataset` of prompts.

This module imports jax and ray_tpu only inside functions: the predictor
classes defined here are pickled by reference, so each predictor actor
imports this module, and the JAX reference runs in the test process.
"""

import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.air.batch_predictor import BatchPredictor, Predictor
from ray_tpu_torch.air.preprocessors import (
    BatchMapper,
    Chain,
    LabelEncoder,
    MinMaxScaler,
    StandardScaler,
)
from ray_tpu_torch.models import TransformerConfig, forward, params_from_numpy

N_PROMPTS = 12
PROMPT_LEN = 6


@pytest.fixture(scope="module")
def rt():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _tabular(n=100):
    rng = np.random.default_rng(0)
    return rd.from_items(
        [
            {"x": float(v), "y": float(3 * v + 1), "label": ["a", "b", "c"][i % 3]}
            for i, v in enumerate(rng.normal(5.0, 2.0, size=n))
        ],
        parallelism=4,
    )


def test_standard_scaler(rt):
    ds = _tabular()
    scaler = StandardScaler(columns=["x", "y"])
    out = scaler.fit_transform(ds)
    batches = list(out.iter_batches(batch_size=1000))
    x = np.concatenate([b["x"] for b in batches])
    assert abs(float(x.mean())) < 1e-6
    assert abs(float(x.std()) - 1.0) < 1e-6
    assert "label" in batches[0]


def test_minmax_scaler_and_chain(rt):
    chain = Chain(
        MinMaxScaler(columns=["x"]),
        BatchMapper(lambda b: {**b, "x2": b["x"] * 2}),
    )
    b = next(chain.fit_transform(_tabular()).iter_batches(batch_size=1000))
    assert float(b["x"].min()) == 0.0 and float(b["x"].max()) == 1.0
    np.testing.assert_allclose(b["x2"], b["x"] * 2)


def test_label_encoder(rt):
    ds = _tabular()
    enc = LabelEncoder(label_column="label").fit(ds)
    assert enc.classes_ == ["a", "b", "c"]
    b = next(enc.transform(ds).iter_batches(batch_size=1000))
    assert set(np.unique(b["label"])) == {0, 1, 2}


def test_unfitted_transform_raises(rt):
    with pytest.raises(RuntimeError, match="must be fit"):
        StandardScaler(columns=["x"]).transform(_tabular())


class LinearPredictor(Predictor):
    @classmethod
    def from_checkpoint(cls, checkpoint, **kw):
        p = cls()
        d = checkpoint.to_dict()
        p.w, p.b = d["w"], d["b"]
        return p

    def predict(self, batch):
        return {"pred": batch["x"] * self.w + self.b}


def test_batch_predictor_linear_model(rt):
    predictor = BatchPredictor.from_checkpoint(Checkpoint.from_dict({"w": 3.0, "b": 1.0}),
                                               LinearPredictor)
    ds = _tabular()
    out = predictor.predict(ds, batch_size=16, num_actors=2)
    preds = np.concatenate([b["pred"] for b in out.iter_batches(batch_size=1000)])
    assert len(preds) == 100
    ys = np.asarray([r["y"] for r in ds.take_all()])
    np.testing.assert_allclose(np.sort(preds), np.sort(ys), rtol=1e-6)


class LMPredictor(Predictor):
    """The tiny decoder restored from a port Checkpoint onto the CPU: the
    next token of each prompt of a batch, in one forward."""

    @classmethod
    def from_checkpoint(cls, checkpoint, **kw):
        p = cls()
        p.cfg = TransformerConfig.tiny()
        p.params = checkpoint.get_torch_state()
        return p

    def predict(self, batch):
        toks = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long)
        with torch.no_grad():
            last = forward(self.params, toks, self.cfg)[:, -1, :]
        return {"id": np.asarray(batch["id"]), "token": last.argmax(-1).numpy(),
                "foreign": np.asarray([len(sys.modules.keys() & {"jax", "ray_tpu"})] * len(toks))}


def test_batch_predictor_gives_the_jax_next_tokens_from_a_port_checkpoint(rt, tmp_path):
    import jax

    from ray_tpu.models import transformer as jax_tf

    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    ckpt = Checkpoint.from_directory(Checkpoint.from_torch_state(tree).to_directory(
        str(tmp_path / "lm")))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (N_PROMPTS, PROMPT_LEN))
    ds = rd.from_items([{"id": i, "tokens": prompts[i].tolist()} for i in range(N_PROMPTS)],
                       parallelism=4)

    out = BatchPredictor.from_checkpoint(ckpt, LMPredictor).predict(ds, batch_size=4,
                                                                    num_actors=2)
    batches = list(out.iter_batches(batch_size=1000))
    ids = np.concatenate([b["id"] for b in batches])
    tokens = np.concatenate([b["token"] for b in batches])
    assert sorted(ids.tolist()) == list(range(N_PROMPTS))
    assert not np.concatenate([b["foreign"] for b in batches]).any()
    ref = np.asarray(jax_tf.forward(params, prompts, cfg))[:, -1, :].argmax(-1)
    assert tokens.tolist() == ref[ids].tolist()
