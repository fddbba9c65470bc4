"""BatchPredictor: offline batched inference over a Dataset.

ray: python/ray/train/batch_predictor.py — loads a model from a Checkpoint
into N predictor ACTORS and streams dataset batches through them.
TPU-first: each predictor actor builds its jitted apply once, then every
batch is a single device dispatch; actors pull blocks via the object store
(no driver round-trip for the data).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """User-implemented: from_checkpoint builds state, predict maps a batch
    (ray: python/ray/train/predictor.py)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


class _PredictorActor:
    def __init__(self, predictor_cls_blob: bytes, ckpt_dir: Optional[str], kwargs):
        import cloudpickle

        cls = cloudpickle.loads(predictor_cls_blob)
        ckpt = Checkpoint.from_directory(ckpt_dir) if ckpt_dir else None
        self.predictor = cls.from_checkpoint(ckpt, **(kwargs or {}))

    def predict_shard(self, shard, batch_size: int):
        """Run every batch of a Dataset shard; returns list of out-batches."""
        out = []
        for batch in shard.iter_batches(batch_size=batch_size):
            out.append(self.predictor.predict(batch))
        return out


class BatchPredictor:
    def __init__(self, checkpoint: Optional[Checkpoint], predictor_cls, **predictor_kwargs):
        import cloudpickle

        self._ckpt = checkpoint
        self._cls_blob = cloudpickle.dumps(predictor_cls)
        self._kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, predictor_cls, **kw) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **kw)

    def predict(
        self,
        dataset,
        *,
        batch_size: int = 256,
        num_actors: int = 2,
        num_gpus_per_actor: float = 0,
    ):
        """Dataset → Dataset of prediction batches."""
        from ray_tpu_torch import data as rd

        ckpt_dir = self._ckpt.to_directory() if self._ckpt is not None else None
        opts: Dict[str, Any] = {"num_cpus": 1}
        if num_gpus_per_actor:
            opts["num_gpus"] = num_gpus_per_actor
        Actor = ray_tpu_torch.remote(_PredictorActor)
        actors = [
            Actor.options(**opts).remote(self._cls_blob, ckpt_dir, self._kwargs)
            for _ in range(num_actors)
        ]
        try:
            shards = dataset.split(num_actors)
            refs = [
                a.predict_shard.remote(s, batch_size) for a, s in zip(actors, shards)
            ]
            all_batches = []
            for r in ray_tpu_torch.get(refs, timeout=600):
                all_batches.extend(r)
            from ray_tpu_torch.data.block import NumpyBlock

            blocks = [ray_tpu_torch.put(NumpyBlock(b)) for b in all_batches if b]
            return rd.Dataset(blocks or [ray_tpu_torch.put([])])
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
